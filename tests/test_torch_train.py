"""LoRA fine-tuning in the port against ``jenga_tpu.train``: the transport
losses, the adapters (targets, merge, kohya export), the dataset, the
train step with ``torch.optim.AdamW`` against JAX's step with
``optax.adamw`` (dense and carved), and what the step reaches in the
models: ``remat`` and ``sel_mask`` selection replay with JAX's guards.

Inputs, weights and JAX's own t and noise draws are handed to both
packages as numpy arrays; every model config is f32, so the comparisons
test the algorithm.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.models import hyvideo as jhy
from jenga_tpu.models import wan as jwan
from jenga_tpu.train import dataset as jdataset
from jenga_tpu.train import lora as jlora
from jenga_tpu.train import make_lora_train_step as jax_step
from jenga_tpu.train import transport as jtr
from jenga_tpu_torch.convert import (hyvideo_params_from_jax, lora_from_jax,
                                     merge_lora, wan_params_from_jax)
from jenga_tpu_torch.models import hyvideo as thy
from jenga_tpu_torch.models import wan as twan
from jenga_tpu_torch.train import dataset as tdataset
from jenga_tpu_torch.train import lora as tlora
from jenga_tpu_torch.train import make_lora_train_step
from jenga_tpu_torch.train import transport as ttr

from _torch_parity import rel_err

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny shapes: they gain
    nothing from more (measured alone: 17.4 s at one thread, 16.3 s at
    eight), and the suite runs several worker processes on the machine's
    cores, where each extra thread only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_train.py's tiny Wan
WAN_TRAIN = dict(dim=32, ffn_dim=64, freq_dim=16, num_heads=2, num_layers=2,
                 text_dim=16, text_len=4, dtype="float32")
# tests/test_wan_model.py's and tests/test_hyvideo_model.py's TINY
WAN_TINY = dict(dim=128, ffn_dim=256, freq_dim=32, num_heads=2,
                num_layers=1, text_dim=64, text_len=16, dtype="float32")
HY_TINY = dict(hidden_size=128, heads_num=2, double_blocks=1,
               single_blocks=1, rope_dim_list=(16, 24, 24),
               text_states_dim=48, text_states_dim_2=24, refiner_depth=1,
               guidance_embed=True, dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _wan(kw, seed=0, head_seed=9):
    """JAX init (numpy tree) with tests/test_train.py's live head, and the
    port's model on the same weights."""
    cfg = jwan.WanConfig(**kw)
    base = _np_tree(jwan.init_wan_params(jax.random.PRNGKey(seed), cfg))
    w = base["head"]["linear"]["w"]
    base["head"]["linear"]["w"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(head_seed), w.shape)) * 0.1
    model = twan.WanDiT(twan.WanConfig(**kw))
    model.load_state_dict(wan_params_from_jax(base), strict=True)
    return cfg, base, model


def _hy(kw, seed=9):
    cfg = jhy.HYVideoConfig(**kw)
    base = _np_tree(jhy.init_hyvideo_params(jax.random.PRNGKey(seed), cfg))
    w = base["final_layer"]["linear"]["w"]
    base["final_layer"]["linear"]["w"] = np.random.default_rng(1) \
        .standard_normal(w.shape).astype(np.float32) * 0.05
    model = thy.HYVideoDiT(thy.HYVideoConfig(**kw))
    model.load_state_dict(hyvideo_params_from_jax(base), strict=True)
    return cfg, base, model


# ------------------------------------------------------------- transport

PATHS = ("linear", "gvp", "vp")
PREDICTIONS = ("velocity", "noise", "score")
WEIGHTS = ("none", "velocity", "likelihood")


def _model_fn(xt, t_model):
    """The same deterministic stand-in for a DiT in both packages."""
    scale = 1.0 + 1e-4 * t_model
    return 0.5 * xt[:, :4] * scale.reshape((-1, 1, 1, 1, 1))


def _loss_both(cfg_kw, cond=None, seed=3):
    """(port loss, JAX loss) for one config, JAX's t and noise fed to the
    port: JAX splits the key into the t and the noise draws."""
    jcfg, tcfg = jtr.TransportConfig(**cfg_kw), ttr.TransportConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((2, 4, 3, 4, 4)).astype(np.float32)
    cl = x1[:, :, :1] + 0.1 if cond else None
    key = jax.random.PRNGKey(seed)
    k_t, k_n = jax.random.split(key)
    t = np.asarray(jtr.sample_t(jcfg, k_t, 2))
    x0 = np.asarray(jax.random.normal(k_n, x1.shape, jnp.float32))
    want, _ = jtr.training_loss(jcfg, _model_fn, key, jnp.asarray(x1),
                                i2v_condition_type=cond,
                                cond_latents=None if cl is None
                                else jnp.asarray(cl))
    got, aux = ttr.training_loss(tcfg, _model_fn, None, _t(x1),
                                 i2v_condition_type=cond,
                                 cond_latents=None if cl is None else _t(cl),
                                 timestep=_t(t), noise=_t(x0))
    assert np.array_equal(aux["t"].numpy(), t)
    return got, want


@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("path", PATHS)
def test_training_loss_matches_jax(path, prediction, weight):
    """Every path x prediction x loss weight (train_eps 1e-3 keeps the
    noise and score weights finite), JAX's t and noise fed to the port:
    the per-example losses within 1e-5 relative."""
    got, want = _loss_both(dict(path_type=path, prediction=prediction,
                                loss_weight=weight, train_eps=1e-3,
                                shift=3.0))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("prediction", ("velocity", "noise"))
@pytest.mark.parametrize("cond", ("latent_concat", "token_replace"))
def test_training_loss_i2v_conditioning_matches_jax(cond, prediction):
    """The I2V conditioning modes (the model input's extra channels or the
    replaced first frame, and token_replace's loss over frames 1..)
    against JAX, 1e-5 relative."""
    got, want = _loss_both(dict(prediction=prediction, train_eps=1e-3,
                                reverse=prediction == "noise"), cond=cond)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("reverse", (False, True))
@pytest.mark.parametrize("shift", (1.0, 7.0))
@pytest.mark.parametrize("snr", ("uniform", "lognorm"))
def test_sample_t_matches_jax(monkeypatch, snr, shift, reverse):
    """t sampling: the same uniform or normal draw handed to both (JAX's
    draw patched to the port's), then the range and the SD3 shift, 1e-6."""
    kw = dict(snr_type=snr, shift=shift, reverse=reverse, train_eps=1e-3,
              path_type="gvp")
    gen = torch.Generator().manual_seed(11)
    got = ttr.sample_t(ttr.TransportConfig(**kw), gen, 64)
    gen = torch.Generator().manual_seed(11)
    draw = (torch.rand if snr == "uniform" else torch.randn)(
        (64,), generator=gen).numpy()
    monkeypatch.setattr(jax.random, "uniform" if snr == "uniform"
                        else "normal", lambda key, shape: jnp.asarray(draw))
    want = jtr.sample_t(jtr.TransportConfig(**kw), jax.random.PRNGKey(0), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------------ LoRA


@pytest.mark.parametrize("kind", ("wan", "hy"))
def test_lora_targets_match_jax(kind):
    """``DEFAULT_TARGETS`` picks the same layers in both packages (JAX tree
    paths with dots), with the same a/b shapes."""
    cfg, base, model = _wan(WAN_TRAIN) if kind == "wan" else _hy(HY_TINY)
    want = jlora.init_lora(jax.random.PRNGKey(1), base, rank=4)
    got = tlora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    assert sorted(got) == sorted(k.replace("/", ".") for k in want)
    for k, ab in want.items():
        for n in ("a", "b"):
            assert tuple(got[k.replace("/", ".")][n].shape) == ab[n].shape
    assert not any(torch.count_nonzero(ab["b"]) for ab in got.values())
    assert tlora.lora_param_count(got) == jlora.lora_param_count(want)


def _live_lora(base, rank=4, seed=1):
    lora = jlora.init_lora(jax.random.PRNGKey(seed), base, rank=rank)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1, lora)


def test_apply_lora_matches_jax_bit_for_bit():
    """The merged weights, ``W + scale * (b @ a)`` in f32 (JAX's ``[in,
    out]`` with the transposed delta), equal JAX's bit for bit; untargeted
    weights are the base's own tensors."""
    _, base, model = _wan(WAN_TRAIN)
    lora = _live_lora(base)
    want = wan_params_from_jax(_np_tree(jlora.apply_lora(base, lora,
                                                         scale=2.0)))
    got = tlora.apply_lora(model, lora_from_jax(lora), scale=2.0)
    assert sorted(got) == sorted(want)
    for name, w in got.items():
        assert torch.equal(w.detach(), want[name]), name
    assert got["patch_embedding.w"] is model.patch_embedding.w


def test_export_kohya_matches_jax_and_merges():
    """``export_kohya`` gives JAX's keys and arrays for the same adapters,
    and the export merged by ``convert.merge_lora`` into a state dict
    gives ``apply_lora``'s weight (1e-6 relative)."""
    _, base, model = _hy(HY_TINY)
    lora = _live_lora(base)
    want = jlora.export_kohya(lora)
    tl = lora_from_jax(lora)
    got = tlora.export_kohya(tl)
    assert sorted(got) == sorted(want)
    for key, x in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(x)), key
    merged = tlora.apply_lora(model, tl)
    params = dict(model.named_parameters())
    sd = merge_lora({f"{name}.weight": params[f"{name}.w"].detach().clone()
                     for name in tl}, got, prefix="Hunyuan_video_I2V")
    for name in tl:
        assert rel_err(sd[f"{name}.weight"], merged[f"{name}.w"].detach()) \
            <= 1e-6, name


def test_dataset_batches_match_jax(tmp_path):
    """The copied ``LatentDataset`` reads the reference's data-json layout
    into the same buckets and batches as JAX's."""
    jdir = tmp_path / "jsons"
    jdir.mkdir()
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(4, 2, 8, 8)] * 3 + [(4, 2, 4, 4)]):
        npy = str(tmp_path / f"{i}.npy")
        np.save(npy, rng.standard_normal(shape).astype(np.float32))
        (jdir / f"{i}.json").write_text(json.dumps({
            "video_id": f"v{i}", "latent_shape": list(shape),
            "prompt": f"p{i}", "npy_save_path": npy}))
    a = list(jdataset.LatentDataset(str(jdir), uncond_p=0.5).batches(
        2, np.random.default_rng(3)))
    b = list(tdataset.LatentDataset(str(jdir), uncond_p=0.5).batches(
        2, np.random.default_rng(3)))
    assert len(a) == len(b) == 1
    assert a[0]["ids"] == b[0]["ids"] and a[0]["prompts"] == b[0]["prompts"]
    assert np.array_equal(a[0]["latents"], b[0]["latents"])


# ------------------------------------------------------------ train step


def _wan_batch(cfg, shape, seed=2):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "context": rng.standard_normal(
                (shape[0], cfg.text_len, cfg.text_dim)).astype(np.float32)}


def _steps_both(kw, shape, n, rank, lr, carve_args=None):
    """n steps of JAX's step (optax.adamw(lr)) and of the port's
    (torch AdamW, weight_decay 1e-4) from the same adapters, with JAX's
    fixed key's t and noise fed to the port every step."""
    cfg, base, model = _wan(kw)
    batch = _wan_batch(cfg, shape)
    jcarve = tcarve = None
    if carve_args is not None:
        grid = (shape[2], shape[3] // 2, shape[4] // 2)
        jcarve = jwan.make_wan_carve(cfg, build_curve_plan(grid, "sliced",
                                                           128), **carve_args)
        tcarve = twan.make_wan_carve(model.cfg, grid, **carve_args)
    tcfg = dict(shift=7.0)

    def japply(params, xt, t, b):
        return jwan.wan_forward(params, cfg, xt, t, b["context"],
                                carve=jcarve)

    lora0 = _np_tree(jlora.init_lora(jax.random.PRNGKey(3), base,
                                     rank=rank))
    opt = optax.adamw(lr)
    jlora_, state = lora0, opt.init(lora0)
    step = jax_step(japply, jtr.TransportConfig(**tcfg), opt)
    key = jax.random.PRNGKey(4)
    jb = jax.tree.map(jnp.asarray, batch)
    want = []
    for _ in range(n):
        jlora_, state, loss = step(jlora_, state, base, jb, key)
        want.append(float(loss))

    k_t, k_n = jax.random.split(key)
    t = np.asarray(jtr.sample_t(jtr.TransportConfig(**tcfg), k_t,
                                shape[0]))
    x0 = np.asarray(jax.random.normal(k_n, shape, jnp.float32))

    def tapply(params, xt, t, b):
        return functional_call(model, params, (xt, t, b["context"]),
                               {"carve": tcarve})

    lora = lora_from_jax(lora0)
    topt = torch.optim.AdamW(tlora.lora_tensors(lora), lr=lr,
                             weight_decay=1e-4)
    tstep = make_lora_train_step(tapply, ttr.TransportConfig(**tcfg), topt)
    base_t = dict(model.named_parameters())
    tb = {k: _t(v) for k, v in batch.items()}
    got = [float(tstep(lora, base_t, tb, timestep=_t(t), noise=_t(x0)))
           for _ in range(n)]
    return got, want, lora, jlora_, model, base_t, tb, tstep


def test_lora_steps_match_jax():
    """3 steps on tests/test_train.py's tiny Wan: the loss of every step
    within 1e-5 relative of JAX's, and each adapter after them within 1e-3
    relative L2 (Adam divides each gradient element by its own running
    norm, so the last-bit differences of the f32 gradients grow in a few
    small elements: measured 1.5e-4 at worst, the median element 3e-7
    off). The base received no gradient."""
    got, want, lora, jl, model, base_t, *_ = _steps_both(
        WAN_TRAIN, (2, 16, 2, 8, 8), 3, 4, 3e-2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, ab in jl.items():
        for n in ("a", "b"):
            assert rel_err(lora[name.replace("/", ".")][n].detach(),
                           ab[n]) <= 1e-3, (name, n)
    assert all(w.grad is None and not w.requires_grad
               for w in base_t.values())
    assert got[2] < got[0]


def test_lora_finetune_loss_decreases():
    """tests/test_train.py's end-to-end check on the port: 40 steps on one
    batch with one fixed (t, noise) draw drop the loss below 0.8x its
    start, still improving at the end."""
    cfg, base, model = _wan(WAN_TRAIN)
    batch = {k: _t(v) for k, v in _wan_batch(cfg, (2, 16, 2, 8, 8)).items()}
    lora = tlora.init_lora(torch.Generator().manual_seed(3), model, rank=4)
    opt = torch.optim.AdamW(tlora.lora_tensors(lora), lr=3e-2,
                            weight_decay=1e-4)
    step = make_lora_train_step(
        lambda p, xt, t, b: functional_call(model, p, (xt, t, b["context"])),
        ttr.TransportConfig(shift=7.0), opt)
    base_t = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(4)
    t = ttr.sample_t(ttr.TransportConfig(shift=7.0), gen, 2)
    x0 = torch.randn(batch["latents"].shape, generator=gen)
    losses = [float(step(lora, base_t, batch, timestep=t, noise=x0))
              for _ in range(40)]
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])
    assert min(losses[-5:]) <= min(losses)


def test_carved_lora_step_matches_jax():
    """One step of tests/test_sparse_autodiff.py's carved case (1 layer,
    latents (1, 16, 2, 32, 32): 512 tokens, 4 blocks, sa_drop_rate 0.75)
    through both steps, so the recompute backward of the block-sparse
    attention is inside: the loss within 1e-5 relative and the adapters
    within 1e-4 relative L2 of JAX's (Pallas kernels in interpret mode
    there)."""
    got, want, lora, jl, *_ = _steps_both(
        dict(WAN_TRAIN, num_layers=1), (1, 16, 2, 32, 32), 1, 2, 1e-2,
        carve_args=dict(sa_drop_rate=0.75, p_remain=0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, ab in jl.items():
        for n in ("a", "b"):
            assert rel_err(lora[name.replace("/", ".")][n].detach(),
                           ab[n]) <= 1e-4, (name, n)


# ------------------------------------------------------ remat, sel_mask


def _grads(model, fn):
    params = [p for p in model.parameters()]
    for p in params:
        p.requires_grad_(True)
    try:
        out = fn()
        grads = torch.autograd.grad(out.square().mean(), params,
                                    allow_unused=True)
    finally:
        for p in params:
            p.requires_grad_(False)
    return out.detach(), grads


def _wan_inputs(cfg, lat, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, cfg.in_dim, *lat)).astype(np.float32)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    return x, np.full((1,), 600.0, np.float32), ctx


def _hy_inputs(cfg, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, cfg.in_channels, 4, 16, 16)).astype(
        np.float32)
    txt = rng.standard_normal((1, 8, cfg.text_states_dim)).astype(np.float32)
    mask = np.ones((1, 8), np.int32)
    mask[0, 6:] = 0
    txt2 = rng.standard_normal((1, cfg.text_states_dim_2)).astype(np.float32)
    return (x, np.array([500.0], np.float32), txt, mask, txt2,
            np.array([1000.0], np.float32))


@pytest.mark.parametrize("kind", ("wan", "hy"))
def test_remat_matches_plain_forward_and_grads(kind):
    """``remat=True`` (each block under torch.utils.checkpoint, its forward
    recomputed in the backward, the carved kernels' recompute backward
    inside) gives the same output and the same gradient of every parameter
    as ``remat=False``, on a carved tiny Wan and a carved tiny HY (1e-6
    relative L2)."""
    if kind == "wan":
        cfg, _, model = _wan(dict(WAN_TINY, num_layers=2))
        x, t, ctx = (_t(a) for a in _wan_inputs(cfg, (4, 16, 24)))
        carve = twan.make_wan_carve(model.cfg, (4, 8, 12), 0.5, 0.9,
                                    q_rows=2, joint_sel=True)

        def run(remat):
            return model(x, t, ctx, carve=carve, remat=remat)
    else:
        cfg, _, model = _hy(HY_TINY)
        x, t, txt, mask, txt2, g = (_t(a) for a in _hy_inputs(cfg))
        carve = thy.make_hy_carve(model.cfg, (4, 8, 8), 0.5, 0.5,
                                  text_amp=-1.0, txt_block_num=1)

        def run(remat):
            return model(x, t, txt, mask, txt2, carve=carve, guidance=g,
                         remat=remat)
    out0, g0 = _grads(model, lambda: run(False))
    out1, g1 = _grads(model, lambda: run(True))
    assert out0.abs().max() > 0 and torch.equal(out0, out1)
    assert sum(a is not None for a in g0) > 10
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None and a.any():
            assert rel_err(b, a) <= 1e-6


@pytest.mark.parametrize("kind", ("wan", "hy"))
def test_lora_grads_under_functional_call_with_remat(kind):
    """The LoRA gradients through ``functional_call`` with the merged
    weights are the same with ``remat=True`` as without (1e-6 relative
    L2), on the carved tiny models: the checkpoint's recompute runs in
    the backward, after functional_call has given the module its own
    parameters back, so it must be handed the merged ones."""
    if kind == "wan":
        cfg, _, model = _wan(dict(WAN_TINY, num_layers=2))
        x, t, ctx = (_t(a) for a in _wan_inputs(cfg, (4, 16, 24)))
        carve = twan.make_wan_carve(model.cfg, (4, 8, 12), 0.5, 0.9,
                                    q_rows=2, joint_sel=True)

        def run(p, remat):
            return functional_call(model, p, (x, t, ctx),
                                   {"carve": carve, "remat": remat})
    else:
        cfg, _, model = _hy(HY_TINY)
        x, t, txt, mask, txt2, g = (_t(a) for a in _hy_inputs(cfg))
        carve = thy.make_hy_carve(model.cfg, (4, 8, 8), 0.5, 0.5,
                                  text_amp=-1.0, txt_block_num=1)

        def run(p, remat):
            return functional_call(model, p, (x, t, txt, mask, txt2),
                                   {"carve": carve, "guidance": g,
                                    "remat": remat})
    lora = tlora.init_lora(torch.Generator().manual_seed(2), model, rank=2)
    with torch.no_grad():
        for ab in lora.values():
            ab["b"].normal_(generator=torch.Generator().manual_seed(3))
    grads = []
    for remat in (False, True):
        out = run(tlora.apply_lora(model, lora), remat)
        grads.append(torch.autograd.grad(out.square().mean(),
                                         tlora.lora_tensors(lora)))
    for a, b in zip(*grads):
        assert a.abs().max() > 0 and rel_err(b, a) <= 1e-6


def test_wan_sel_mask_replay_matches_planner():
    """``WanCarve.sel_mask`` set to the planner's own mask (JAX's
    ``wan_first_selection_mask``, bit-equal to the port's planner in f32)
    reproduces the planner path exactly on a one-layer trunk."""
    cfg, base, model = _wan(WAN_TINY)
    x, t, ctx = _wan_inputs(cfg, (4, 16, 24))
    plan = build_curve_plan((4, 8, 12), "sliced", 128)
    jcarve = jwan.make_wan_carve(cfg, plan, sa_drop_rate=0.5, p_remain=0.9)
    mask = np.asarray(jwan.wan_first_selection_mask(base, cfg, x, t, ctx,
                                                    jcarve))
    carve = twan.make_wan_carve(model.cfg, (4, 8, 12), 0.5, 0.9)

    def run(cv):
        h0, aux = model.embed(_t(x), _t(t), _t(ctx), cv)
        return model.trunk(h0, aux, cv)

    a = run(carve)
    b = run(dataclasses.replace(carve, sel_mask=_t(mask)))
    assert a.abs().max() > 0 and torch.equal(a, b)


def test_wan_sel_mask_guards_fail_loudly():
    """As JAX's: a sel_mask on the dense fallback (drop <= 0.25) raises,
    and a mask of another grid fails the shape check."""
    cfg, _, model = _wan(WAN_TINY)
    x, t, ctx = (_t(a) for a in _wan_inputs(cfg, (4, 16, 24)))
    carve = twan.make_wan_carve(model.cfg, (4, 8, 12), 0.5, 0.9)
    good = torch.ones((1, 2, 3, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="dense fallback"):
        model(x, t, ctx, carve=dataclasses.replace(carve, sa_drop_rate=0.2,
                                                   sel_mask=good))
    with pytest.raises(ValueError, match="sel_mask shape"):
        model(x, t, ctx, carve=dataclasses.replace(
            carve, sel_mask=torch.ones((1, 2, 4, 4), dtype=torch.bool)))


def test_hy_sel_mask_replay_matches_planner_and_guards():
    """``HYCarve.sel_mask`` set to JAX's ``hy_first_selection_mask`` plus
    the all-true text rows reproduces the planner path exactly on a
    one-double-block trunk; a sel_mask on a non-carved call raises
    NotImplementedError, and a mask of another grid fails the shape
    check, as in JAX."""
    kw = dict(HY_TINY, single_blocks=0)
    cfg, base, model = _hy(kw)
    x, t, txt, mask, txt2, g = _hy_inputs(cfg)
    plan = build_curve_plan((4, 8, 8), "gilbert", 128)
    jcarve = jhy.make_hy_carve(cfg, plan, sa_drop_rate=0.5, p_remain=0.5,
                               text_amp=-1.0, txt_block_num=1)
    m = np.asarray(jhy.hy_first_selection_mask(
        base, cfg, *map(jnp.asarray, (x, t, txt, mask, txt2)), jcarve,
        guidance=jnp.asarray(g)))
    b_, h_, tsb, nb = m.shape
    full = np.concatenate([m, np.ones((b_, h_, nb - tsb, nb), bool)], axis=2)
    carve = thy.make_hy_carve(model.cfg, (4, 8, 8), 0.5, 0.5, text_amp=-1.0,
                              txt_block_num=1)

    def run(cv, xx=x):
        img, txth, aux = model.embed(_t(xx), _t(t), _t(txt), _t(mask),
                                     _t(txt2), cv, _t(g))
        return model.trunk(img, txth, aux, cv)

    a = run(carve)
    b = run(dataclasses.replace(carve, sel_mask=_t(full)))
    assert a.abs().max() > 0 and torch.equal(a, b)
    with pytest.raises(ValueError, match="sel_mask shape"):
        run(dataclasses.replace(carve, sel_mask=_t(full[:, :, 1:])))
    small = thy.make_hy_carve(model.cfg, (2, 4, 6), 0.5, 0.5, text_amp=-1.0,
                              txt_block_num=1)
    with pytest.raises(NotImplementedError, match="sel_mask"):
        run(dataclasses.replace(small, sel_mask=torch.ones(
            (1, 2, 1, 1), dtype=torch.bool)), xx=x[:, :, :2, :8, :12])

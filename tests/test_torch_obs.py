"""The port's tracing (``jenga_tpu_torch.obs``) on the CPU: spans cost
nothing while tracing is off, a profiled tiny Wan ``generate`` and a tiny
HunyuanVideo one carry the ``jenga.*`` spans with the stated nesting and
counts, tracing changes no output bit, and the sync counter counts a sync
warning once under the innermost span and prints nothing."""

import collections
import warnings

import pytest
import torch

from jenga_tpu_torch import obs
from jenga_tpu_torch.models import hyvideo as hy
from jenga_tpu_torch.models import layers as L
from jenga_tpu_torch.models import wan
from jenga_tpu_torch.pipelines.hyvideo_t2v import (HYT2VOptions,
                                                   HYVideoT2VPipeline)
from jenga_tpu_torch.pipelines.wan_t2v import WanT2VOptions, WanT2VPipeline


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.disable()
    yield
    obs.disable()


def _wan_case():
    """Two Wan steps (a dense warm-up step, then a carved one) on 2880
    tokens, two blocks."""
    cfg = wan.WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                        text_dim=64, text_len=32, dtype="float32")
    model = wan.WanDiT(cfg)
    gen = torch.Generator().manual_seed(0)
    wan.init_wan_(model, gen)
    with torch.no_grad():
        model.head_layer.linear.w.normal_(generator=gen).mul_(0.05)
    pipe = WanT2VPipeline(model)
    opts = WanT2VOptions(size=(384, 384), frame_num=17, sampling_steps=2,
                         sa_drop_rates=(0.75,), teacache_thresh=None,
                         q_group=8, joint_sel=True)
    ctx, null = torch.randn(8, 64, generator=gen), torch.randn(
        20, 64, generator=gen)
    return (lambda: pipe.generate(ctx, null, opts, decode=False),
            pipe.step_plan(opts), cfg.num_layers,
            ("embed", "trunk", "head", "guidance", "solver"))


def _hy_case():
    """Two carved HunyuanVideo steps (one double and two single blocks)
    on 1152 image and 32 text tokens."""
    cfg = hy.HYVideoConfig(hidden_size=256, heads_num=2, double_blocks=1,
                           single_blocks=2, text_states_dim=64,
                           text_states_dim_2=32, dtype="float32")
    model = hy.HYVideoDiT(cfg)
    gen = torch.Generator().manual_seed(0)
    hy.init_hyvideo_(model, gen)
    with torch.no_grad():
        model.final_layer.linear.w.normal_(generator=gen).mul_(0.05)
        model.final_layer.adaLN.w.normal_(generator=gen).mul_(0.05)
    pipe = HYVideoT2VPipeline(model)
    opts = HYT2VOptions(size=(256, 128), video_length=33,
                        num_inference_steps=2, sa_drop_rates=(0.75,),
                        res_rate_list=(1.0,), step_rate_list=(1.0,),
                        scheduler_shift_list=(7.0,), enable_skip=False,
                        q_group=8, joint_sel=True)
    text = torch.randn(32, 64, generator=gen)
    mask = torch.arange(32) < 20
    pooled = torch.randn(32, generator=gen)
    return (lambda: pipe.generate(text, mask, pooled, opts, decode=False),
            ["carved", "carved"], cfg.double_blocks + cfg.single_blocks,
            ("embed", "trunk", "head", "solver"))


CASES = {"wan": _wan_case, "hyvideo": _hy_case}


def _span_tree(prof):
    """Each ``jenga.*`` event of a trace (``jenga.sync`` aside) with its
    enclosing ``jenga.*`` events, outermost first."""
    out = []
    for e in prof.events():
        if not e.name.startswith(obs.PREFIX) or e.name == "jenga.sync":
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(obs.PREFIX):
                chain.append(p)
            p = p.cpu_parent
        out.append((e, chain[::-1]))
    return out


def test_span_off_is_one_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not obs.enabled()
    assert obs.span("layout") is obs.span("norm", "args")
    assert obs.step(0, 0, "dense") is obs.span("step")
    x = torch.randn(2, 8, 4, 16)
    cos, sin = torch.ones(8, 8), torch.zeros(8, 8)
    assert torch.equal(L.apply_rope(x, cos, sin), x)
    L.layer_norm(L.modulate(L.silu(x), shift=x, scale=x))


@pytest.mark.parametrize("family", sorted(CASES))
def test_profiled_generate_carries_nested_spans(family):
    generate, kinds, blocks, stages = CASES[family]()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        generate()
    tree = _span_tree(prof)
    name = {id(e): e.name[len(obs.PREFIX):] for e, _ in tree}
    count = collections.Counter(name[id(e)] for e, _ in tree)
    steps = [e for e, chain in tree if name[id(e)] == "step"]
    assert len(steps) == len(kinds)
    assert all(not chain for e, chain in tree if name[id(e)] == "step")

    def under(e, n):
        return [p for p in dict(tree)[e] if name[id(p)] == n]

    # every other span sits in a step: the stages directly, the blocks
    # in the trunk, the elementwise chains and copies mostly in a block
    for e, chain in tree:
        if name[id(e)] != "step":
            assert chain and name[id(chain[0])] == "step", name[id(e)]
    for stage in stages:
        assert count[stage] == len(kinds)
        assert all(len(dict(tree)[e]) == 1
                   for e, _ in tree if name[id(e)] == stage)
    block_spans = [e for e, _ in tree if name[id(e)] == "block"]
    assert len(block_spans) == blocks * len(kinds)
    assert all(under(b, "trunk") for b in block_spans)
    for leaf in ("norm", "rope", "layout", "modulate", "act"):
        assert any(under(e, "block") for e, _ in tree
                   if name[id(e)] == leaf), leaf
    # the planner: two spans (the selection, then the block lists) in
    # each carved block, none in a dense step
    for s, kind in zip(steps, kinds):
        in_step = [e for e, chain in tree if s in chain]
        planners = [e for e in in_step if name[id(e)] == "planner"]
        assert all(under(p, "block") for p in planners)
        assert len(planners) == (2 * blocks if kind == "carved" else 0)


@pytest.mark.parametrize("family", sorted(CASES))
def test_tracing_changes_no_output_bit(family):
    generate = CASES[family]()[0]
    off = generate()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = generate()
    assert obs.enabled()        # it followed the profiler
    obs.enable()
    on_again = generate()
    obs.disable()
    assert torch.equal(off, on) and torch.equal(off, on_again)


def test_sync_counter_counts_once_under_innermost_and_prints_nothing(
        monkeypatch):
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    filters, show = list(warnings.filters), warnings.showwarning
    before = obs.syncs()
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            warnings.warn(obs.SYNC_MESSAGE + " (Triggered internally at "
                          "CUDAFunctions.cpp:1.)", UserWarning)
        warnings.warn(obs.SYNC_MESSAGE, UserWarning)
    warnings.warn(obs.SYNC_MESSAGE, UserWarning)
    warnings.warn_explicit("a plain warning", UserWarning, "f.py", 1)
    obs.disable()
    after = obs.syncs()
    gained = {k: n - before.get(k, 0) for k, n in after.items()}
    assert {k: n for k, n in gained.items() if n} == {
        "inner": 1, "outer": 1, None: 1}
    # the sync warnings went nowhere, the other one to the hook found
    assert shown == ["a plain warning"]
    assert warnings.filters == filters and warnings.showwarning is show
    assert not obs.enabled()

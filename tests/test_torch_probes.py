"""The probe kernels' plain versions (P1-P4, ``jenga_tpu_torch/ops``)
against the JAX tools' own Pallas kernels, run in interpret mode on the
CPU, and the port's probe tools against what the JAX tools build.

The JAX tools run their timing at module level, so only their kernel and
wrapper definitions are loaded (with ``ast``), with the shape globals the
wrappers read supplied and ``pl.pallas_call`` bound to ``interpret=True``.
Inputs are f32 from seeded numpy: the Pallas kernels then compute in f32
and agree with the plain versions to rounding (tolerance 2e-5).

Traps: the TPU P1 kernel and P2's ``oracle``/``nomax`` apply no mask, so
in the unfilled tail of a DMA group they attend a block that is not
listed; the lists here give every group a count that is a multiple of the
DMA group width, where no such tail exists. P1's ``compute_only`` reads
never-filled scratch on the TPU (NaN in interpret mode), so its plain
version is held against its definition through ``ops/attention_ref.py``.
"""

import ast
import functools
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jenga_tpu.curves.blocks import build_curve_plan
from jenga_tpu.sparse import planner as jax_planner
from jenga_tpu_torch.ops.attention_probe import (EPILOGUE_VARIANTS,
                                                 SPLIT_VARIANTS,
                                                 attention_probe,
                                                 attention_probe_plain)
from jenga_tpu_torch.ops.attention_ref import block_sparse_attention_reference
from jenga_tpu_torch.ops.block_pool import block_pool, block_pool_plain
from jenga_tpu_torch.ops.cross_attention_resident import (
    cross_attention_resident, cross_attention_resident_plain)
from jenga_tpu_torch.ops.sparse_dispatch import block_lists_from_mask
from jenga_tpu_torch.tools import (epilogue_probe, kernel_cases_ab,
                                   kernel_split_probe, pool_probe,
                                   short_kernel_probe, wan_overhead_probe2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 2e-5      # f32 on both sides: summation order only
NB, H, GROUP = 8, 2, 4     # 8 blocks of 128, 2 heads, DMA group width 4


def _load_tool(rel, names, **shape_globals):
    """The named top-level functions of a JAX tool, executed without its
    module-level code, with Pallas in interpret mode."""
    tree = ast.parse((ROOT / rel).read_text())
    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in keep} == set(names)
    pl_interp = types.SimpleNamespace(**vars(pl))
    pl_interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "pl": pl_interp, "pltpu": pltpu,
          "functools": functools, "_LOG2E": 1.4426950408889634,
          **shape_globals}
    exec(compile(ast.Module(body=keep, type_ignores=[]), rel, "exec"), ns)
    return types.SimpleNamespace(**{n: ns[n] for n in names})


def _qkv(seed, b=1, h=H, s=NB * 128, d=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _mask_with_counts(seed, rows, h=H, counts=(GROUP, 2 * GROUP)):
    """[1, h, rows, NB] bool: each row selects a random set of blocks whose
    size is drawn from ``counts`` (multiples of the DMA group width)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((1, h, rows, NB), bool)
    for hi in range(h):
        for r in range(rows):
            sel = rng.choice(NB, size=rng.choice(counts), replace=False)
            m[0, hi, r, sel] = True
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("variant", ["both", "copy_only"])
def test_p1_plain_matches_tpu_kernel(variant):
    """P1 ``both`` (gather and compute) and ``copy_only`` (gather only) vs
    ``tools/kernel_split_probe.py``'s ``variant`` in interpret mode."""
    tool = _load_tool("tools/kernel_split_probe.py", ["_kernel", "variant"])
    q, k, v = _qkv(30, h=1)     # interpret mode's cost grows with the grid
    mask = _mask_with_counts(31, NB, h=1)
    lists = jax_planner.pack_block_lists(
        *jax_planner.mask_to_block_lists(jnp.asarray(mask)))
    out = tool.variant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lists,
                       do_dma=True, do_compute=variant == "both",
                       group=GROUP)
    idx, cnt, _ = block_lists_from_mask(_t(mask), 1)
    sl = torch.tensor([NB * 128], dtype=torch.int32)
    ref = attention_probe_plain(variant, _t(q), _t(k), _t(v), idx, cnt, sl)
    assert np.abs(np.asarray(out) - ref.numpy()).max() <= TOL
    if variant == "copy_only":
        assert not ref.any()


@pytest.mark.parametrize("q_rows", [1, 4])
def test_p1_compute_only_is_attention_over_the_first_block(q_rows):
    """compute_only runs the tile math ``n`` times over each group's first
    listed block: softmax over ``n`` copies of its keys, which is the
    attention over that block alone (the reference on a one-block mask)."""
    q, k, v = (_t(x) for x in _qkv(32))
    mask = _t(_mask_with_counts(33, NB))
    mask[0, 1, 2] = False               # an empty row stays empty
    idx, cnt, _ = block_lists_from_mask(mask, q_rows, q_rows > 1)
    sl = torch.tensor([NB * 128], dtype=torch.int32)
    got = attention_probe_plain("compute_only", q, k, v, idx, cnt, sl,
                                q_rows=q_rows)
    first = torch.zeros_like(mask)
    for hi in range(H):
        for r in range(NB):
            g = r // q_rows
            if cnt[0, hi, g] > 0:
                first[0, hi, r, idx[0, hi, g, 0]] = True
    assert torch.allclose(
        got, block_sparse_attention_reference(q, k, v, first), atol=TOL)
    # the definition itself: n copies of one block's keys, one softmax
    hi, r = 1, 5
    g, n = r // q_rows, int(cnt[0, hi, r // q_rows])
    blk = int(idx[0, hi, g, 0])
    keys = k[0, hi, blk * 128:(blk + 1) * 128].repeat(n, 1)
    vals = v[0, hi, blk * 128:(blk + 1) * 128].repeat(n, 1)
    rows = q[0, hi, r * 128:(r + 1) * 128]
    p = torch.softmax(rows @ keys.T * 128 ** -0.5, dim=-1)
    assert torch.allclose(got[0, hi, r * 128:(r + 1) * 128], p @ vals,
                          atol=TOL)
    assert not got[0, 1, 2 * 128:3 * 128].any() or q_rows > 1


@pytest.mark.parametrize("variant", EPILOGUE_VARIANTS)
def test_p2_plain_matches_tpu_kernel(variant):
    """Each P2 epilogue vs ``tools/epilogue_probe.py``'s ``run_variant``
    in interpret mode: q_rows 4, text_amp 1.0 on the video rows' text
    columns (tsb = NB - 2), which oracle and nomax do not apply."""
    tool = _load_tool("tools/epilogue_probe.py",
                      ["_kernel_variant", "run_variant"])
    q_rows = 4
    q, k, v = _qkv(34, h=1)
    gmask = _mask_with_counts(35, NB // q_rows, h=1)
    lists = jax_planner.pack_block_lists(
        *jax_planner.mask_to_block_lists(jnp.asarray(gmask)))
    out = tool.run_variant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           lists, q_rows=q_rows, group=GROUP,
                           variant=variant, text_amp=1.0)
    row_mask = _t(np.repeat(gmask, q_rows, axis=2))
    idx, cnt, _ = block_lists_from_mask(row_mask, q_rows, True)
    sl = torch.tensor([NB * 128], dtype=torch.int32)
    ref = attention_probe_plain(variant, _t(q), _t(k), _t(v), idx, cnt, sl,
                                q_rows=q_rows, text_amp=1.0,
                                text_start_block=NB - 2)
    assert np.abs(np.asarray(out) - ref.numpy()).max() <= TOL


def test_p3_plain_matches_tpu_kernel():
    """P3's plain version (the f32 block mean) vs the pool probe's
    ``pool_pallas`` at chunk 4 and 8, and vs the tool's own f32 mean."""
    b, h, d = 2, 2, 128
    s = NB * 128
    tool = _load_tool("tools/pool_probe.py", ["_pool_kernel", "pool_pallas"],
                      b=b, h=h, d=d, s=s, nb=NB)
    x = np.random.default_rng(36).standard_normal((b, h, s, d)) \
        .astype(np.float32)
    ref = block_pool_plain(_t(x)).numpy()
    for chunk in (4, 8):
        out = np.asarray(tool.pool_pallas(jnp.asarray(x), chunk=chunk))
        assert np.abs(out - ref).max() <= 1e-6
    tool_ref = np.asarray(jnp.asarray(x).reshape(b, h, NB, 128, d).mean(3))
    assert np.abs(tool_ref - ref).max() <= 1e-6
    assert torch.equal(block_pool(_t(x)), block_pool_plain(_t(x)))


def test_p4_plain_matches_tpu_kernel():
    """P4's plain version vs ``cross_resident`` in interpret mode and vs
    the tool's einsum reference (``wan_overhead_probe2.py:150-153``)."""
    b, h, d, s = 2, 2, 128, 1024
    tool = _load_tool("tools/wan_overhead_probe2.py",
                      ["_xkernel", "cross_resident"], b=b, h=h, d=d, s=s)
    rng = np.random.default_rng(37)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kx, vx = (rng.standard_normal((b, h, 512, d)).astype(np.float32)
              for _ in range(2))
    kvx = jnp.concatenate([kx, vx], axis=-1).reshape(b * h, 512, 2 * d)
    out = np.asarray(tool.cross_resident(jnp.asarray(q), kvx, bq=512))
    ref = cross_attention_resident(_t(q), _t(kx), _t(vx)).numpy()
    assert np.abs(out - ref).max() <= TOL
    einsum = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(
        jnp.einsum("bhqd,bhkd->bhqk", q, kx) * d ** -0.5, -1), vx)
    assert np.abs(np.asarray(einsum) - ref).max() <= TOL
    assert torch.equal(cross_attention_resident_plain(_t(q), _t(kx), _t(vx)),
                       _t(ref))


def test_p1_tool_lists_match_jax_tool():
    """The port's P1 lists (``probe_lists``, q_rows 1) equal the JAX
    tool's ``make_lists`` (planner mask over the curve's adjacency, full
    text rows, packed lists) on the same f32 q, k: ids and counts. The
    grid is cut to 32 video blocks, so the tool's top_k of 225 of 900
    blocks becomes 8 of 32 on both sides."""
    grid, top_k = (4, 32, 32), 8
    plan = build_curve_plan(grid, "gilbert", 128)
    s = -(-(plan.seq_len + 256) // 128) * 128
    nb, tsb = s // 128, s // 128 - 2
    q, k, _ = _qkv(38, h=H, s=s)
    planner = dict(vars(jax_planner))
    planner["build_block_mask"] = _with_top_k(jax_planner.build_block_mask,
                                              top_k)
    tool = _load_tool("tools/kernel_split_probe.py", ["make_lists"],
                      P=types.SimpleNamespace(**planner), b=1, h=H, nb=nb,
                      tsb=tsb, plan=plan)
    packed = np.asarray(tool.make_lists(jnp.asarray(q), jnp.asarray(k)))
    idx, cnt = kernel_split_probe.probe_lists(_t(q), _t(k), plan, tsb, 1,
                                              top_k=top_k, p_remain=0.05)
    counts = packed[..., 0]
    assert np.array_equal(counts, cnt.numpy())
    assert 0 < counts[..., :tsb].mean() < nb      # a real selection
    for hi in range(H):
        for r in range(nb):
            c = counts[0, hi, r]
            assert np.array_equal(packed[0, hi, r, 2:2 + c],
                                  idx[0, hi, r, :c].numpy())


def _with_top_k(fn, top_k):
    def call(*args, **kw):
        return fn(*args, **{**kw, "top_k": top_k})
    return call


def test_p2_banded_mask_matches_jax_tool():
    """The port's banded mask equals the JAX tool's construction
    (``epilogue_probe.py:307-315``) at 904 blocks, density 0.27."""
    nb, density = 904, 0.27
    tsb, win = nb - 2, int(density * nb)
    rows, cols = jnp.arange(nb)[:, None], jnp.arange(nb)[None, :]
    center = jnp.clip(rows, win // 2, tsb - win // 2)
    local = jnp.abs(cols - center) <= win // 2
    local = local.at[..., tsb:].set(True).at[tsb:].set(True)
    got = epilogue_probe.banded_mask(1, 1, nb, density)[0, 0]
    assert np.array_equal(np.asarray(local), got.numpy())


@pytest.mark.parametrize("q_rows", [1, 3, 8])
def test_check_vs_plain_slices_hold_the_whole_output(q_rows):
    """The tools' check holds an output against the plain version in
    slices of whole groups (text_amp placed by ``q_start_block``): the
    whole plain output passes it exactly, in full and on three slices, and
    an output made without text_amp fails its relative bound."""
    nb, tsb = 56, 54        # four chunks of 16 (or 15) query blocks
    q, k, v = (_t(x) for x in _qkv(39, s=nb * 128))
    mask = torch.rand((1, H, nb, nb),
                      generator=torch.Generator().manual_seed(40)) < 0.4
    mask[..., tsb:] = True
    idx, cnt, _ = block_lists_from_mask(mask, q_rows, q_rows > 1)
    sl = torch.tensor([nb * 128 - 50], dtype=torch.int32)
    kw = dict(q_rows=q_rows, text_amp=1.0, text_start_block=tsb)
    whole = attention_probe_plain("both", q, k, v, idx, cnt, sl, **kw)
    for full in (True, False):
        r = kernel_split_probe.check_vs_plain("both", whole, q, k, v, idx,
                                              cnt, sl, full=full, **kw)
        assert r["max_abs_err"] <= 1e-6 and r["rel_err"] <= 1e-6
        assert (r["checked_blocks"] == nb) == full
    no_amp = attention_probe_plain("both", q, k, v, idx, cnt, sl,
                                   **{**kw, "text_amp": 0.0})
    r = kernel_split_probe.check_vs_plain("both", no_amp, q, k, v, idx, cnt,
                                          sl, full=False, **kw)
    assert r["rel_err"] > 2e-2


def test_probe_tools_run_on_cpu():
    """Each tool's run() end to end at a tiny shape on the CPU (the plain
    versions): its variants, errors within the stated bounds, and the
    launch counters untouched (no kernel runs on the CPU)."""
    before = (attention_probe.split_launches,
              attention_probe.epilogue_launches, block_pool.launches,
              cross_attention_resident.launches)
    r1 = kernel_split_probe.run((2, 6, 8), reps=1, check=True, device="cpu")
    assert set(r1["modes"]) == {"k2_q1", "k1_q8"}
    for rec in r1["modes"].values():
        assert set(rec["variants"]) == set(SPLIT_VARIANTS)
        assert all(r["max_abs_err"] <= 1e-2 for r in rec["variants"].values())
    r2 = epilogue_probe.run(16, reps=1, check=True, heads=1, device="cpu")
    assert set(r2["variants"]) == set(EPILOGUE_VARIANTS)
    assert all(r["max_abs_err"] <= 1e-2 for r in r2["variants"].values())
    r3 = pool_probe.run((3, 4, 16), reps=1, planner_reps=1, heads=1,
                        device="cpu")
    assert all(e <= 1e-4 for e in r3["max_abs_err"].values())
    assert r3["planner_masks_equal"]
    r4 = wan_overhead_probe2.run(256, bqs=(128, 256), reps=1, heads=1,
                                 pool=False, device="cpu")
    assert all(r["max_abs_err"] <= 1e-2 for r in r4["attn"].values())
    assert (attention_probe.split_launches,
            attention_probe.epilogue_launches, block_pool.launches,
            cross_attention_resident.launches) == before


def test_probe_tools_refuse_a_missing_card():
    """The tools default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool_probe.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_cases_ab.run(str(ROOT), str(ROOT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        short_kernel_probe.run()
    with pytest.raises(ValueError):
        attention_probe("dense", *[torch.zeros(1)] * 6)


@pytest.mark.parametrize("phase", ["kernels", "train"])
def test_kernel_cases_ab_reads_its_runs(monkeypatch, phase):
    """``kernel_cases_ab`` reads a run's output as ``chip_smoke.py``
    prints it: the indented phase-2 records (a backward case's dK|dV and
    dQ ms as rows of their own), or phase 16's step seconds and gradient
    norms; lines of other text are ignored. The child's output here is a
    stand-in: the runs themselves need the card."""
    rec = {"kernel": "dense_attn_bwd", "case": "b_wan_cross", "ms": 1.3,
           "dkv_ms": 0.64, "dq_ms": 0.63}
    steps = {"dense": [{"s": 3.7, "grad_norm": 2.3, "loss": 2.6}],
             "carved": [{"s": 36.1, "grad_norm": 1.4, "loss": 2.2}]}
    stdout = (f"== 2. kernels vs plain on the card\n   {json.dumps(rec)}\n"
              f"TRAIN {json.dumps(steps)}\n")
    seen = []

    def fake_run(cmd, cwd, **kw):
        seen.append(cmd[-1])
        return types.SimpleNamespace(returncode=0, stdout=stdout, stderr="")
    monkeypatch.setattr(kernel_cases_ab.subprocess, "run", fake_run)
    got = kernel_cases_ab._one(str(ROOT), 10, phase)
    assert got[("dense_attn_bwd", "b_wan_cross", None, None)] == 1.3
    assert got[("dense_attn_bwd.dkv", "b_wan_cross", None, None)] == 0.64
    assert got[("dense_attn_bwd.dq", "b_wan_cross", None, None)] == 0.63
    assert got[("lora_step", "dense", 0, "s")] == 3.7
    assert got[("lora_step", "carved", 0, "grad_norm")] == 1.4
    assert ("phase_train_wan" in seen[0]) == (phase == "train")
    assert ("phase_kernel_cases" in seen[0]) == (phase == "kernels")


@pytest.mark.parametrize("variant", sorted(short_kernel_probe.VARIANTS))
def test_short_kernel_probe_variants_edit_the_kernel(variant):
    """Each variant of the short-key kernel's probe finds the text it
    edits exactly once in the kernel's source, so the probe keeps
    measuring what it names as the kernel changes."""
    from jenga_tpu_torch.ops.flash_attention import SHORT_KERNEL_SOURCE
    src = SHORT_KERNEL_SOURCE.read_text()
    edited = short_kernel_probe.variant_source(variant)
    old, new = short_kernel_probe.VARIANTS[variant]
    assert edited != src and src.count(old) == 1
    assert len(edited) == len(src) - len(old) + len(new)

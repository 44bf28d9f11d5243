"""The frozen operation and byte counts against hand counts, and the GEMM
counts of a step against the matmuls the port's model runs at a small
size (every ``F.linear`` it calls, counted as it is called)."""

import contextlib

import pytest
import torch
import torch.nn.functional as F

import _tiny
from benchmark.flops import hyvideo as hy_flops
from benchmark.flops import roofline as R
from benchmark.flops import wan as wan_flops


def test_roofline_hand_counts():
    # 3 tiles of QK^T and PV at d = 128: 3 * 2 * (2 * 128^3)
    assert R.attention_tiles_flop(3) == 3 * 2 * 2 * 128 ** 3
    assert R.attention_tiles_flop(1, 64) == 4 * 128 * 128 * 64
    # q 1x2x256x128 and k 1x2x512x128 in bf16: q, o, k, v once
    assert R.attention_bytes(65536, 131072) == (65536 * 2 + 131072 * 2) * 2
    flop, nbytes = R.dense_attention(2, 3, 256, 512, 128)
    assert flop == 4 * 2 * 3 * 256 * 512 * 128
    assert nbytes == 2 * (2 * 3 * 256 * 128 + 2 * 3 * 512 * 128) * 2
    # bytes bound below, operations bound above
    assert R.bound_s(989e12, 0) == pytest.approx(1.0)
    assert R.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_wan_token_counts():
    _, c = _tiny.run.load_cell("wan13b-480p-carved")
    assert wan_flops.tokens(c, (16, 21, 60, 104)) == (32760, 32768, 512)


@contextlib.contextmanager
def _counting():
    total = [0]
    orig = F.linear

    def linear(x, w, b=None):
        total[0] += 2 * x.numel() // x.shape[-1] * w.shape[0] * w.shape[1]
        return orig(x, w, b)

    F.linear = linear
    try:
        yield total
    finally:
        F.linear = orig


def test_wan_gemm_count_matches_the_model():
    from jenga_tpu_torch.models.wan import WanConfig, WanDiT, make_wan_carve
    w, c = _tiny.tiny("wan13b-480p-carved")
    cfg = WanConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in c.items() if k in
                       WanConfig.__dataclass_fields__})
    model = WanDiT(cfg)
    for p in model.parameters():
        p.data.normal_(0, 0.02)
    shape = (16, 5, 48, 48)
    carve = make_wan_carve(cfg, (5, 24, 24), 0.0, 0.9, q_rows=8,
                           joint_sel=True)
    with _counting() as total, torch.no_grad():
        model(torch.randn(2, *shape), torch.full((2,), 500.0),
              torch.randn(2, c["text_len"], c["text_dim"]), carve)
    assert total[0] == wan_flops.gemm_flop(c, shape)


def test_hyvideo_gemm_count_matches_the_model():
    from jenga_tpu_torch.models.hyvideo import (HYVideoConfig, HYVideoDiT,
                                                make_hy_carve)
    w, c = _tiny.tiny("hy-720p125f-carved")
    cfg = HYVideoConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in c.items() if k in
                           HYVideoConfig.__dataclass_fields__})
    model = HYVideoDiT(cfg)
    for p in model.parameters():
        p.data.normal_(0, 0.02)
    shape = (16, 9, 16, 32)
    carve = make_hy_carve(cfg, (9, 8, 16), 0.75, 0.3, q_rows=8,
                          joint_sel=True)
    st = 256
    with _counting() as total, torch.no_grad():
        model(torch.randn(1, *shape), torch.full((1,), 500.0),
              torch.randn(1, st, c["text_states_dim"]),
              torch.ones(1, st, dtype=torch.int32),
              torch.randn(1, c["text_states_dim_2"]), carve,
              guidance=torch.full((1,), 6000.0))
    assert total[0] == hy_flops.gemm_flop(c, shape, st)

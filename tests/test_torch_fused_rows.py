"""The dispatch of the DiT trunk's fused row kernels on the CPU: which
inputs ``ops.fused_rows`` refuses and why, that every refused input
(CPU tensors, f32 rows, inputs that require grad, HunyuanVideo's token
replacement) takes the plain chain unchanged with every ``.launches`` at
0, the moved ``layers.gated``, and the models' calls into the kernels:
with the kernels' rule patched to take CPU inputs and each launch
replaced by a plain statement of what the kernel computes, tiny Wan and
HunyuanVideo blocks make the calls the card makes and give the chain's
output. (The kernels themselves run only on a card:
``tests/test_torch_fused_rows_gpu.py``.)"""

from unittest import mock

import pytest
import torch

from jenga_tpu_torch.models import hyvideo as H
from jenga_tpu_torch.models import layers as L
from jenga_tpu_torch.models import wan as W
from jenga_tpu_torch.ops import fused_rows as FR

BF16 = torch.bfloat16
COUNTERS = (FR.norm_modulate, FR.rms_norm_rope, FR.gated_residual)
GEN = torch.Generator().manual_seed(0)


def _counts():
    return [(f.launches, f.fallbacks) for f in COUNTERS]


def _rand(*shape, dtype=BF16):
    return torch.randn(shape, generator=GEN).to(dtype)


def _vec(b, d):
    """An f32 [B, 1, d] slice of a [B, 6, d] table, as the models cut
    their modulation."""
    return torch.randn((b, 6, d), generator=GEN)[:, 2:3]


def _chain(x, w=None, b=None, shift=None, scale=None, rms=False):
    y = L.rms_norm(x, w) if rms else L.layer_norm(x, w, b)
    return y if shift is None and scale is None else L.modulate(y, shift,
                                                                scale)


def test_fitting_bf16_rows_are_refused_only_for_the_device():
    x = _rand(2, 24, 64)
    w, b = torch.randn(64, generator=GEN), torch.randn(64, generator=GEN)
    shift, scale = _vec(2, 64), _vec(1, 64)
    assert FR.row_refusal(x, w, b, shift, scale) == "not on a CUDA device"
    qkv = _rand(2, 24, 3, 4, 32)            # a strided q view, heads of 32
    cos, sin = torch.randn(20, 16), torch.randn(20, 16)
    assert FR.row_refusal(qkv[:, :, 0], w[:32], cos=cos, sin=sin,
                          rope_rows=20) == "not on a CUDA device"
    assert FR.gated_refusal(x, x, shift) == "not on a CUDA device"


@pytest.mark.parametrize("case,expect", [
    ("f32", "float32"), ("row_100", "row length 100"),
    ("row_too_long", f"row length {FR.MAX_ROW + 8}"),
    ("misaligned", "16-byte aligned"), ("2d", "2 dims"),
    ("bf16_weight", "weight"), ("vector_per_token", "shift of shape"),
    ("rope_head_12", "RoPE tables"), ("rope_short_table", "RoPE tables"),
    ("autograd", "autograd")])
def test_row_refusal_reasons(case, expect):
    x, args, kw = _rand(2, 24, 64), {}, {}
    if case == "f32":
        x = x.float()
    elif case in ("row_100", "row_too_long"):
        x = _rand(2, 3, 100 if case == "row_100" else FR.MAX_ROW + 8)
    elif case == "misaligned":
        x = _rand(2, 24, 72)[..., 8:]       # rows not at a 16-byte stride
        x = x.as_strided(x.shape, (24 * 72, 72, 1), 1)
    elif case == "2d":
        x = x[0]
    elif case == "bf16_weight":
        args["weight"] = _rand(64)
    elif case == "vector_per_token":
        args["shift"] = torch.randn(2, 24, 64)
    elif case == "rope_head_12":
        kw = dict(cos=torch.randn(24, 6), sin=torch.randn(24, 6),
                  rope_rows=24)
    elif case == "rope_short_table":
        kw = dict(cos=torch.randn(20, 16), sin=torch.randn(20, 16),
                  rope_rows=24)
    elif case == "autograd":
        args["weight"] = torch.ones(64, requires_grad=True)
    assert expect in FR.row_refusal(x, **args, **kw)
    if case == "autograd":
        with torch.no_grad():
            assert FR.row_refusal(x, **args) == "not on a CUDA device"


def test_gated_refusal_reasons():
    x, gate = _rand(2, 8, 64), _vec(2, 64)
    assert "float32" in FR.gated_refusal(x.float(), x.float(), gate)
    assert "not shaped as x" in FR.gated_refusal(x, x[:1], gate)
    assert "not contiguous" in FR.gated_refusal(x.transpose(0, 1),
                                                x.transpose(0, 1), gate)
    assert "gate" in FR.gated_refusal(x, x, torch.randn(2, 8, 64))
    assert "gate" in FR.gated_refusal(x, x, torch.randn(64))
    assert "autograd" in FR.gated_refusal(
        x, x, torch.randn((2, 1, 64), requires_grad=True))


@pytest.mark.parametrize("dtype,grad", [(BF16, False), (torch.float32,
                                                        False),
                                        (torch.float32, True)])
def test_refused_inputs_take_the_chain_unchanged(dtype, grad):
    """CPU tensors, f32 rows and inputs that require grad: the chain's own
    result bit for bit (and its gradient), no launch, and no fallback
    counted (they are not CUDA calls)."""
    before = _counts()
    x = _rand(2, 24, 64, dtype=dtype).requires_grad_(grad)
    w = torch.randn(64, generator=GEN)
    shift, scale = _vec(2, 64), _vec(2, 64)
    out = L.norm_modulate(x, shift=shift, scale=scale)
    assert torch.equal(out, _chain(x, shift=shift, scale=scale))
    assert torch.equal(L.norm_modulate(x, w, w, rms=False),
                       _chain(x, w, w))
    assert torch.equal(L.norm_modulate(x, w, rms=True),
                       _chain(x, w, rms=True))
    cos, sin = torch.randn(24, 16), torch.randn(24, 16)
    rope = L.rms_norm_rope(x, w, cos, sin, rope_rows=20)
    normed = L.rms_norm(x, w).reshape(2, 24, 2, 32)
    want = torch.cat([L.apply_rope(normed[:, :20], cos[:20], sin[:20]),
                      normed[:, 20:]], dim=1).reshape(2, 24, 64)
    assert torch.equal(rope, want)
    gated = L.gated(x, out, scale)
    assert torch.equal(gated, (x.float() + out.float() * scale).to(dtype))
    if grad:
        (out.sum() + rope.sum() + gated.sum()).backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert _counts() == before


def test_gated_is_the_models_former_gated_residual():
    """``layers.gated`` replaces the two identical ``_gated`` of the Wan
    and HunyuanVideo modules: x + y * gate in f32, cast to x's dtype, in
    the ``modulate`` span."""
    assert not hasattr(W, "_gated") and not hasattr(H, "_gated")
    for dtype in (BF16, torch.float32):
        x, y, gate = _rand(2, 5, 16, dtype=dtype), _rand(2, 5, 16), \
            _vec(2, 16)
        out = L.gated(x, y, gate)
        assert out.dtype == dtype
        assert torch.equal(out, (x.float() + y.float() * gate).to(dtype))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    from jenga_tpu_torch import obs
    obs.enable()
    try:
        with prof:
            L.gated(x, y, gate)
    finally:
        obs.disable()
    names = [e.name for e in prof.events()]
    assert "jenga.modulate" in names


def _norm_spec(x, weight, bias, shift, scale, cos, sin, rope_rows, eps,
               rms):
    """What the row-norm kernel computes, stated apart from the chain:
    the row's f32 statistics, the affine, one bf16 rounding, then the
    modulation or the rotation of each head's (even, odd) pairs of the
    tokens s < rope_rows by cos[s], sin[s]."""
    xf = x.float()
    if rms:
        y = xf / torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        c = xf - xf.mean(-1, keepdim=True)
        y = c / torch.sqrt(c.square().mean(-1, keepdim=True) + eps)
    y = y * (1 if weight is None else weight) + (0 if bias is None
                                                 else bias)
    if shift is None and scale is None and cos is None:
        return y.to(BF16)
    y = y.to(BF16).float()
    if scale is not None:
        y = y * (1 + scale)
    if shift is not None:
        y = y + shift
    if cos is not None:
        hd = 2 * cos.shape[1]
        pairs = y.reshape(*y.shape[:2], -1, hd // 2, 2).clone()
        view = (1, rope_rows) + (1,) * (pairs.dim() - 4) + (hd // 2,)
        c, s = cos[:rope_rows].reshape(view), sin[:rope_rows].reshape(view)
        e, o = pairs[:, :rope_rows, ..., 0], pairs[:, :rope_rows, ..., 1]
        pairs[:, :rope_rows] = torch.stack([e * c - o * s, o * c + e * s],
                                           -1)
        y = pairs.reshape(y.shape)
    return y.to(BF16)


class _SpecKernels:
    """The kernels' rule set to take CPU inputs (a refusal other than the
    device still refuses) and the launches themselves replaced by
    ``_norm_spec`` and the gated residual: the wrappers' checks and
    counters run as on the card."""

    def __init__(self):
        self.row, self.gate = FR.row_refusal, FR.gated_refusal

    def _cpu(self, rule):
        def refusal(*a, **k):
            why = rule(*a, **k)
            return None if why == "not on a CUDA device" else why
        return refusal

    def __enter__(self):
        gated = lambda x, y, gate: (x.float() + y.float() * gate).to(x.dtype)
        self.patches = [
            mock.patch.object(FR, "row_refusal", self._cpu(self.row)),
            mock.patch.object(FR, "gated_refusal", self._cpu(self.gate)),
            mock.patch.object(FR, "_row_norm", _norm_spec),
            mock.patch.object(FR, "_gated", gated)]
        for p in self.patches:
            p.start()
        self.before = _counts()
        return self

    def __exit__(self, *exc):
        self.gained = [(a - c, b - d) for (a, b), (c, d)
                       in zip(_counts(), self.before)]
        for p in reversed(self.patches):
            p.stop()


def _close(a, b, tol=2e-2):
    a, b = a.float(), b.float()
    assert ((a - b).norm() / b.norm()).item() <= tol


def _tiny_init(block):
    with torch.no_grad():
        for mod in block.modules():
            L.init_affine_or_norm_(mod, GEN)
        for p in block.parameters():
            if p.dtype == torch.float32 and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=GEN) * 0.2 + 1)


def test_wan_block_calls_the_kernels():
    """A bf16 Wan block (dim 256, 2 heads of 128): 5 norm_modulate (norm1
    + modulate, the cross q and k, norm3, norm2 + modulate), 2
    rms_norm_rope and 2 gated_residual calls with the arguments the
    kernels take, and the chain's output within bf16's noise."""
    cfg = W.WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=1,
                      text_dim=64, freq_dim=32)
    blk = W.WanBlock(cfg, "cpu")
    _tiny_init(blk)
    with torch.no_grad():
        blk.modulation.normal_(generator=GEN).div_(16)
    grid = (2, 4, 8)
    cos, sin = (torch.as_tensor(a) for a in W.wan_rope_tables(cfg, grid))
    x, ctx = _rand(2, 64, 256), _rand(2, 16, 256)
    e6 = torch.randn((2, 6, 256), generator=GEN)
    with torch.no_grad():
        with _SpecKernels() as k:
            out = blk(x, e6, ctx, None, cos, sin)
        ref = blk(x, e6, ctx, None, cos, sin)
    assert k.gained == [(5, 0), (2, 0), (2, 0)]
    _close(out, ref)


def test_hy_blocks_call_the_kernels_and_token_replacement_does_not():
    """bf16 HunyuanVideo double and single blocks (hidden 256, 2 heads of
    128): the double block makes 6 norm_modulate, 2 rms_norm_rope and 4
    gated_residual calls, the single block 1, 2 and 1 (RoPE on the image
    prefix of the joint rows), each with the chain's output within bf16's
    noise; under token replacement the image stream's modulations and
    gates take the chain (the text stream's calls remain)."""
    cfg = H.HYVideoConfig(hidden_size=256, heads_num=2,
                          rope_dim_list=(32, 48, 48), double_blocks=1,
                          single_blocks=1)
    grid = (2, 4, 4)
    cos, sin = (torch.as_tensor(a) for a in H.hy_rope_tables(cfg, grid))
    img, txt = _rand(1, 32, 256), _rand(1, 16, 256)
    vec = torch.randn((1, 256), generator=GEN)
    seqlen = torch.tensor([40], dtype=torch.int32)
    double, single = H.DoubleBlock(cfg, "cpu"), H.SingleBlock(cfg, "cpu")
    _tiny_init(double)
    _tiny_init(single)
    mask = torch.arange(32) < 8
    tr = dict(vec=torch.randn((1, 256), generator=GEN), mask_img=mask,
              mask_full=torch.cat([mask, torch.zeros(16, dtype=bool)]))
    x = torch.cat([img, txt], dim=1)
    with torch.no_grad():
        for replace, want_double, want_single in (
                (None, [(6, 0), (2, 0), (4, 0)], [(1, 0), (2, 0), (1, 0)]),
                (tr, [(4, 0), (2, 0), (2, 0)], [(0, 0), (2, 0), (0, 0)])):
            with _SpecKernels() as k:
                out = double(img, txt, vec, None, cos, sin, seqlen, replace)
            assert k.gained == want_double
            for a, b in zip(out, double(img, txt, vec, None, cos, sin,
                                        seqlen, replace)):
                _close(a, b)
            with _SpecKernels() as k:
                out = single(x, vec, None, cos, sin, 16, seqlen, replace)
            assert k.gained == want_single
            _close(out, single(x, vec, None, cos, sin, 16, seqlen, replace))

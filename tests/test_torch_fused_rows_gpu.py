"""The fused row kernels (``ops/fused_rows.py``) against the PyTorch chains
they replace, on a CUDA card (skipped without one): ``norm_modulate``,
``rms_norm_rope`` and ``gated_residual`` at the benchmark cells' shapes
(Wan 1.3B's [2, 32768, 1536] with the zero pad rows of the carved
sequence, HunyuanVideo's [1, 115456, 3072] and its q/k views of the fused
qkv with a RoPE prefix), an odd row count, Wan-14B's width, the inputs
the kernels refuse (which take the chain), and whole Wan and HunyuanVideo
blocks on the kernel path against the chain. This file imports no JAX,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_fused_rows_gpu.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from jenga_tpu_torch.models import hyvideo as H
from jenga_tpu_torch.models import layers as L
from jenga_tpu_torch.models import wan as W
from jenga_tpu_torch.ops import fused_rows as FR

BF16 = torch.bfloat16
COUNTERS = (FR.norm_modulate, FR.rms_norm_rope, FR.gated_residual)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the row kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _counts():
    return [(f.launches, f.fallbacks) for f in COUNTERS]


def _gained(before):
    return [(a - c, b - d) for (a, b), (c, d) in zip(_counts(), before)]


def _rows(gen, shape, device, pad=0):
    """bf16 activations N(0, 2) + 0.5 with the last ``pad`` tokens of
    each sample zero (the carved sequence's pad rows)."""
    x = torch.randn(shape, generator=gen, device=device) * 2 + 0.5
    if pad:
        x[:, -pad:] = 0
    return x.to(BF16)


def _vecs(gen, b, n, d, device):
    """n f32 [B, 1, d] chunks of one [B, n, d] table, as the models slice
    their modulation."""
    e = torch.randn((b, n, d), generator=gen, device=device) * 0.5
    return tuple(e[:, i:i + 1] for i in range(n))


def _ulp(t):
    """One bf16 unit in the last place at each value of t."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _agree(out, ref, slack):
    """The kernel's bf16 output against the chain's: equal but where the
    two sums' order moved a rounding, within the two paths' last roundings
    (two units of the output) plus ``slack`` (what one unit of the
    chain's intermediate rounding can become downstream), at under 0.1%
    of the elements."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == BF16
    assert torch.isfinite(out).all()
    diff = (out.float() - ref.float()).abs()
    assert (diff <= 2 * _ulp(ref) + slack).all(), diff.max().item()
    assert (out != ref).float().mean().item() < 1e-3


def _norm_chain(x, w, b, shift, scale, rms, eps=1e-6):
    y = L.rms_norm(x, w, eps) if rms else L.layer_norm(x, w, b, eps)
    return y if shift is None and scale is None else L.modulate(y, shift,
                                                                scale)


NORM_CASES = {
    # Wan's norm1 + modulate over the carved sequence (pad rows zero)
    "wan_ln_modulate": ((2, 32768, 1536), 8, False, False, True),
    # Wan's norm3: LayerNorm with its f32 affine, no modulation
    "wan_ln_affine": ((2, 32768, 1536), 8, False, True, False),
    # Wan's cross-attention q: RMSNorm over dim with its weight
    "wan_rms_q": ((2, 32768, 1536), 8, True, True, False),
    # HunyuanVideo's image stream
    "hy_ln_modulate": ((1, 115456, 3072), 0, False, False, True),
    "odd_rows": ((1, 1001, 1536), 3, False, True, True),
    "wan14b_width": ((2, 777, 5120), 0, False, False, True),
    "short_row": ((3, 333, 64), 0, False, True, True),
    # lengths between the models' own: the next larger shape holds them
    "row_256": ((2, 500, 256), 0, True, True, False),
    "row_2048": ((2, 500, 2048), 0, False, True, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", NORM_CASES)
def test_norm_modulate_matches_chain(cuda_device, case):
    shape, pad, rms, affine, mod = NORM_CASES[case]
    gen = torch.Generator(cuda_device).manual_seed(1)
    b, _, d = shape
    x = _rows(gen, shape, cuda_device, pad)
    w = bias = shift = scale = None
    if affine:
        w = torch.randn(d, generator=gen, device=cuda_device) + 1
        bias = None if rms else torch.randn(d, generator=gen,
                                            device=cuda_device)
    if mod:
        shift, scale = _vecs(gen, b, 6, d, cuda_device)[:2]
    before = _counts()
    out = L.norm_modulate(x, w, bias, shift, scale, rms=rms)
    torch.cuda.synchronize()
    assert _gained(before) == [(1, 0), (0, 0), (0, 0)]
    ref = _norm_chain(x, w, bias, shift, scale, rms)
    slack = 0
    if affine:  # the sums' order moves the affine's terms by a few f32
        #         units, which bf16 keeps where the terms cancel
        n = _norm_chain(x.float(), None, None, None, None, rms).abs()
        slack = 2 ** -17 * (n * w.abs() + (0 if bias is None
                                           else bias.abs()))
    if scale is not None:
        slack = (_ulp(_norm_chain(x, w, bias, None, None, rms)) + slack) \
            * (1 + scale).abs()
    _agree(out, ref, slack)
    if pad:     # zero rows: zero statistics on both paths, equal bits
        assert torch.equal(out[:, -pad:], ref[:, -pad:])


def _tables(gen, rows, hd, device, pad=0):
    """f32 [rows, hd/2] cos/sin of random angles; identity rotations on
    the last ``pad`` rows (the carve's padded tables)."""
    ang = torch.rand((rows, hd // 2), generator=gen, device=device) * 6.3
    cos, sin = ang.cos(), ang.sin()
    if pad:
        cos[-pad:], sin[-pad:] = 1.0, 0.0
    return cos.contiguous(), sin.contiguous()


def _rope_chain(x, w, cos, sin, rope_rows, hd):
    """The models' former chain: ``rms_norm``, heads, ``apply_rope`` on
    the first ``rope_rows`` tokens, the rest concatenated after them."""
    y = L.rms_norm(x, w)
    heads = y.reshape(*y.shape[:2], -1, hd)
    rot = L.apply_rope(heads[:, :rope_rows], cos[:rope_rows],
                       sin[:rope_rows])
    return torch.cat([rot, heads[:, rope_rows:]], dim=1).reshape(y.shape)


ROPE_CASES = {
    # Wan's self-attention q: rows of dim = 12 heads x 128, pad rows zero
    "wan_q": ((2, 32768, 1536), None, 8, None),
    # HunyuanVideo's single block: the q view of qkv [b, s, 3, n, hd]
    # (here a slice of the fused linear1 output), RoPE on the image rows
    "hy_single_q": ((1, 115456, 24, 128), 0, 0, 115200),
    "hy_double_k": ((1, 115200, 24, 128), 1, 0, None),
    "odd_rows": ((1, 1001, 4, 128), 1, 0, 999),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROPE_CASES)
def test_rms_norm_rope_matches_chain(cuda_device, case):
    shape, which, pad, rope_rows = ROPE_CASES[case]
    gen = torch.Generator(cuda_device).manual_seed(2)
    hd = 128
    if which is None:
        x = _rows(gen, shape, cuda_device, pad)
    else:
        b, s, n, _ = shape
        fused = _rows(gen, (b, s, 3 * n * hd + 4 * n * hd), cuda_device)
        x = fused[..., :3 * n * hd].reshape(b, s, 3, n, hd)[:, :, which]
        assert not x.is_contiguous()
    s = shape[1]
    cos, sin = _tables(gen, s if rope_rows is None else rope_rows, hd,
                       cuda_device, pad)
    w = torch.randn(shape[-1], generator=gen, device=cuda_device) + 1
    before = _counts()
    out = L.rms_norm_rope(x, w, cos, sin, rope_rows=rope_rows)
    torch.cuda.synchronize()
    assert _gained(before) == [(0, 0), (1, 0), (0, 0)]
    assert out.is_contiguous() and out.shape == x.shape
    rows = s if rope_rows is None else rope_rows
    ref = _rope_chain(x, w, cos, sin, rows, hd)
    # one unit of each rotated pair's normed inputs, times |cos| + |sin|
    normed = _ulp(L.rms_norm(x, w)).reshape(*x.shape[:2], -1, hd // 2, 2)
    slack = (normed.amax(-1, keepdim=True) * 2).expand_as(normed) \
        .reshape(x.shape)
    _agree(out, ref, slack)


GATED_CASES = {"wan": (2, 32768, 1536), "hy": (1, 115456, 3072),
               "odd_rows": (1, 1001, 1536), "wan14b_width": (2, 777, 5120),
               "row_256": (1, 999, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", GATED_CASES)
def test_gated_residual_is_the_chain_bit_for_bit(cuda_device, case):
    """The same f32 product, sum and rounding as the chain: equal bits."""
    shape = GATED_CASES[case]
    gen = torch.Generator(cuda_device).manual_seed(3)
    x, y = (_rows(gen, shape, cuda_device) for _ in range(2))
    gate = _vecs(gen, shape[0], 6, shape[-1], cuda_device)[2]
    before = _counts()
    out = L.gated(x, y, gate)
    torch.cuda.synchronize()
    assert _gained(before) == [(0, 0), (0, 0), (1, 0)]
    assert torch.equal(out, (x.float() + y.float() * gate).to(BF16))


@pytest.mark.gpu
def test_refused_inputs_take_the_chain(cuda_device):
    """Row lengths the kernels do not take (not a multiple of 8, past
    MAX_ROW), f32 rows, a per-token gate, RoPE heads that are not a
    multiple of 8 and the token replacement: the chain, unchanged, one
    fallback each."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    for d in (100, FR.MAX_ROW + 8):
        x = _rows(gen, (2, 37, d), cuda_device)
        shift, scale = _vecs(gen, 2, 2, d, cuda_device)
        before = _counts()
        out = L.norm_modulate(x, shift=shift, scale=scale)
        assert _gained(before) == [(0, 1), (0, 0), (0, 0)]
        assert torch.equal(out, _norm_chain(x, None, None, shift, scale,
                                            False))
        before = _counts()
        out = L.gated(x, x, shift)
        assert _gained(before) == [(0, 0), (0, 0), (0, 1)]
        assert torch.equal(out, (x.float() + x.float() * shift).to(BF16))
    x = _rows(gen, (2, 37, 256), cuda_device)
    before = _counts()
    out = L.norm_modulate(x.float())
    assert out.dtype == torch.float32
    assert _gained(before) == [(0, 1), (0, 0), (0, 0)]
    per_token = torch.randn((2, 37, 256), generator=gen, device=cuda_device)
    before = _counts()
    L.gated(x, x, per_token)
    assert _gained(before) == [(0, 0), (0, 0), (0, 1)]
    cos, sin = _tables(gen, 37, 12, cuda_device)     # heads of 12
    w = torch.ones(192, device=cuda_device)
    before = _counts()
    out = L.rms_norm_rope(x[..., :192], w, cos, sin)
    assert _gained(before) == [(0, 0), (0, 1), (0, 0)]
    assert torch.equal(out, _rope_chain(x[..., :192], w, cos, sin, 37, 12))
    # HunyuanVideo-I2V's token replacement: a mask over the image tokens
    # picks the t=0 modulation and gate, which the kernels do not take
    d = 256
    tr = {"mask": torch.arange(37, device=cuda_device) < 5,
          "mod1": _vecs(gen, 2, 2, d, cuda_device),
          "gate1": _vecs(gen, 2, 1, d, cuda_device)[0]}
    shift, scale, gate = _vecs(gen, 2, 3, d, cuda_device)
    before = _counts()
    H._mod_tr(x, shift, scale, tr, "mod1")
    H._gate_tr(x, x, gate, tr, "gate1")
    assert _gained(before) == [(0, 1), (0, 0), (0, 1)]


def _refused(*args, **kwargs):
    return "refused for the comparison"


def _both_paths(fn):
    """``fn()`` on the kernels, then with every input refused (the chain),
    and the counters' gains over each."""
    before = _counts()
    fast = fn()
    torch.cuda.synchronize()
    fast_gain = _gained(before)
    with mock.patch.object(FR, "row_refusal", _refused), \
            mock.patch.object(FR, "gated_refusal", _refused):
        before = _counts()
        slow = fn()
        torch.cuda.synchronize()
        slow_gain = _gained(before)
    return fast, slow, fast_gain, slow_gain


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


# a rounding that one path flips goes on through the attention's softmax
# and the block's products: the two paths agree to bf16's noise, not bits
BLOCK_REL_TOL = 1e-2


@pytest.mark.gpu
def test_wan_block_kernels_against_chain(cuda_device):
    """A whole Wan 1.3B block (dim 1536, 12 heads; 4096 tokens over a
    4x32x32 grid, the dense route; 512 text tokens): the kernel path
    launches norm_modulate 5 times (norm1 + modulate, the cross q and k
    RMS norms, norm3, norm2 + modulate), rms_norm_rope 2 (self q and k)
    and gated_residual 2, falls back nowhere, and matches the chain."""
    cfg = W.WAN_T2V_1_3B
    gen = torch.Generator(cuda_device).manual_seed(5)
    blk = W.WanBlock(cfg, cuda_device)
    with torch.no_grad():
        for mod in blk.modules():
            L.init_affine_or_norm_(mod, gen)
        for p, mean in ((blk.self_attn.norm_q, 1), (blk.self_attn.norm_k, 1),
                        (blk.cross_attn.norm_q, 1),
                        (blk.cross_attn.norm_k, 1), (blk.norm3.w, 1),
                        (blk.norm3.b, 0)):
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda_device)
                    * 0.2 + mean)
        blk.modulation.normal_(generator=gen).div_(cfg.dim ** 0.5)
    grid = (4, 32, 32)
    cos, sin = (torch.as_tensor(a, device=cuda_device)
                for a in W.wan_rope_tables(cfg, grid))
    x = _rows(gen, (2, int(np.prod(grid)), cfg.dim), cuda_device)
    e6 = torch.randn((2, 6, cfg.dim), generator=gen, device=cuda_device)
    ctx = _rows(gen, (2, 512, cfg.dim), cuda_device)
    with torch.no_grad():
        fast, slow, fg, sg = _both_paths(
            lambda: blk(x, e6, ctx, None, cos, sin))
    assert fg == [(5, 0), (2, 0), (2, 0)]
    assert sg == [(0, 5), (0, 2), (0, 2)]
    assert _rel(fast, slow) <= BLOCK_REL_TOL


def _hy_block_inputs(cfg, gen, device, si=2048, st=256):
    grid = (2, 32, 32)
    assert int(np.prod(grid)) == si
    cos, sin = (torch.as_tensor(a, device=device)
                for a in H.hy_rope_tables(cfg, grid))
    img = _rows(gen, (1, si, cfg.hidden_size), device)
    txt = _rows(gen, (1, st, cfg.hidden_size), device)
    vec = torch.randn((1, cfg.hidden_size), generator=gen, device=device)
    seqlen = torch.tensor([si + st - 40], dtype=torch.int32, device=device)
    return img, txt, vec, cos, sin, seqlen


def _hy_init(block, gen, device):
    with torch.no_grad():
        for mod in block.modules():
            L.init_affine_or_norm_(mod, gen)
        for p in block.parameters(recurse=False):
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.2
                    + 1)


@pytest.mark.gpu
def test_hy_blocks_kernels_against_chain(cuda_device):
    """A HunyuanVideo double and single block at full width (3072, 24
    heads; 2048 image tokens over a 2x32x32 grid and 256 text tokens, 40
    of them padding; the dense route): the double block launches
    norm_modulate 6 times (both streams' modulations, the text q/k RMS
    norms), rms_norm_rope 2 (the image q/k) and gated_residual 4; the
    single block 1, 2 (q/k over the joint rows, RoPE on the image prefix)
    and 1; nothing falls back, and each matches the chain."""
    cfg = H.HUNYUAN_VIDEO_T2V
    gen = torch.Generator(cuda_device).manual_seed(6)
    img, txt, vec, cos, sin, seqlen = _hy_block_inputs(cfg, gen,
                                                       cuda_device)
    double = H.DoubleBlock(cfg, cuda_device)
    _hy_init(double, gen, cuda_device)
    with torch.no_grad():
        fast, slow, fg, sg = _both_paths(
            lambda: double(img, txt, vec, None, cos, sin, seqlen))
    assert fg == [(6, 0), (2, 0), (4, 0)]
    assert sg == [(0, 6), (0, 2), (0, 4)]
    for a, b in zip(fast, slow):
        assert _rel(a, b) <= BLOCK_REL_TOL
    del double
    single = H.SingleBlock(cfg, cuda_device)
    _hy_init(single, gen, cuda_device)
    x = torch.cat([img, txt], dim=1)
    with torch.no_grad():
        fast, slow, fg, sg = _both_paths(
            lambda: single(x, vec, None, cos, sin, txt.shape[1], seqlen))
    assert fg == [(1, 0), (2, 0), (1, 0)]
    assert sg == [(0, 1), (0, 2), (0, 1)]
    assert _rel(fast, slow) <= BLOCK_REL_TOL

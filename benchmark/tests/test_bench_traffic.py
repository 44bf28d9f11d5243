"""The traffic against its definitions, restated here in numpy: the
aligned-attention tie (each self-attention's k rows equal to its q rows,
every other row as drawn) and the VAE-like latents (a low-resolution
field upsampled with half-pixel linear interpolation, scaled to unit
std and mixed with white noise at sigma 0.6), at a small size."""

import numpy as np
import torch

import _tiny  # noqa: F401  (puts the checkout on sys.path)
from benchmark.traffic import aligned, latents, weights


def _upsample_linear(x, size):
    """Separable linear interpolation of x [B, C, T, H, W] to ``size``
    (T, H, W) with half-pixel centres, the edge samples repeated."""
    for axis, n_out in zip((2, 3, 4), size):
        n_in = x.shape[axis]
        pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5,
                      0, n_in - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (pos - lo).reshape([-1 if a == axis else 1
                                   for a in range(x.ndim)])
        x = np.take(x, lo, axis) * (1 - frac) + np.take(x, hi, axis) * frac
    return x


def _mix(low, noise, sigma=0.6):
    smooth = _upsample_linear(low, noise.shape[2:])
    smooth = smooth / (smooth.std() + 1e-6)
    return (1 - sigma) * smooth + sigma * noise


def test_synth_latents_follow_their_definition():
    rng = np.random.default_rng(7)
    for shape in ((1, 4, 9, 16, 24), (1, 3, 5, 8, 40)):
        low = rng.normal(size=latents.low_shape(shape))
        noise = rng.normal(size=shape)
        want = _mix(low, noise)
        got = latents.mix_latents(torch.tensor(low), torch.tensor(noise))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        assert latents.low_shape(shape) == (
            1, shape[1], max(1, shape[2] // 4), max(1, shape[3] // 8),
            max(1, shape[4] // 8))


def test_synth_latents_are_seeded():
    a, b, c = (latents.synth_latents(torch.Generator().manual_seed(s),
                                     (1, 2, 5, 8, 8)) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) - 1.0) < 0.3


def test_hyvideo_tie_sets_k_rows_to_q_rows():
    d = 8
    gen = torch.Generator().manual_seed(0)
    group = {}
    for blk, name, rows in (("double_blocks", "img_qkv", 3 * d),
                            ("single_blocks", "linear1", 7 * d)):
        group[f"{blk}.0.{name}.w"] = torch.randn(rows, d, generator=gen)
        group[f"{blk}.0.{name}.b"] = torch.randn(rows, generator=gen)
    for name in ("double_blocks.0.img_q_norm", "double_blocks.0.img_k_norm",
                 "single_blocks.0.q_norm", "single_blocks.0.k_norm"):
        group[name] = torch.rand(d, generator=gen)
    drawn = {k: v.clone() for k, v in group.items()}
    aligned.tie_hyvideo(group, d)
    for name, t in group.items():
        if name.endswith((".w", ".b")):
            want = drawn[name].clone()
            want[d:2 * d] = drawn[name][:d]
            assert torch.equal(t, want), name
    assert torch.equal(group["double_blocks.0.img_k_norm"],
                       drawn["double_blocks.0.img_q_norm"])
    assert torch.equal(group["single_blocks.0.k_norm"],
                       drawn["single_blocks.0.q_norm"])
    assert torch.equal(group["double_blocks.0.img_q_norm"],
                       drawn["double_blocks.0.img_q_norm"])


def test_wan_tie_sets_k_to_q():
    gen = torch.Generator().manual_seed(1)
    group = {f"blocks.0.self_attn.{m}.{p}": torch.randn(
        (6, 6) if p == "w" else (6,), generator=gen)
        for m in "qkvo" for p in "wb"}
    group["blocks.0.self_attn.norm_q"] = torch.rand(6, generator=gen)
    group["blocks.0.self_attn.norm_k"] = torch.rand(6, generator=gen)
    drawn = {k: v.clone() for k, v in group.items()}
    aligned.tie_wan(group)
    for name, t in group.items():
        src = name.replace(".k.", ".q.").replace("norm_k", "norm_q")
        assert torch.equal(t, drawn[src]), name


def test_weights_are_seeded_by_group():
    specs = [("a.w", (4, 3), "w", False), ("a.b", (4,), "b", False),
             ("n", (3,), "ln", True), ("m", (2, 3), "mod", True)]
    g1 = weights.make_group(specs, 5, 0, torch.bfloat16, "cpu")
    g2 = weights.make_group(specs, 5, 0, torch.bfloat16, "cpu")
    g3 = weights.make_group(specs, 5, 1, torch.bfloat16, "cpu")
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert not torch.equal(g1["a.w"], g3["a.w"])
    assert g1["a.w"].dtype == torch.bfloat16 and g1["n"].dtype == torch.float32
    assert float((g1["n"] - 1).abs().max()) < 0.5

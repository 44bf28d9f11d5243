"""Operation counts of one Wan2.1 T2V denoising step, from its shapes.

A step runs the model once on the CFG batch of 2 over the curve-ordered
tokens padded to whole 128-token blocks (the GEMMs compute the pad rows
too). Matmul operations count 2 per multiply-add.
"""

from __future__ import annotations


def tokens(cfg: dict, latent_shape):
    """(real tokens, padded tokens, text tokens) of latents [C, F, H, W]."""
    p = cfg["patch_size"]
    _, f, h, w = latent_shape
    s = (f // p[0]) * (h // p[1]) * (w // p[2])
    return s, -(-s // 128) * 128, cfg["text_len"]


def gemm_flop(cfg: dict, latent_shape, batch: int = 2) -> float:
    """Matmul operations of one step: the embeddings (over the real
    tokens), every block's projections and MLP (over the padded ones), the
    head (the real ones again)."""
    d, ffn, p = cfg["dim"], cfg["ffn_dim"], cfg["patch_size"]
    s, s_pad, lt = tokens(cfg, latent_shape)
    patch_in = cfg["in_dim"] * p[0] * p[1] * p[2]
    out = p[0] * p[1] * p[2] * cfg["out_dim"]
    per_block = (2 * s_pad * d * d * 4              # self q, k, v, o
                 + 2 * s_pad * d * d * 2            # cross q, o
                 + 2 * lt * d * d * 2               # cross k, v
                 + 2 * s_pad * d * ffn * 2)         # MLP
    embed = (2 * s * patch_in * d
             + 2 * lt * (cfg["text_dim"] * d + d * d)
             + 2 * (cfg["freq_dim"] * d + d * d + d * 6 * d))
    head = 2 * s * d * out
    return float(batch * (cfg["num_layers"] * per_block + embed + head))


"""Operation counts of one HunyuanVideo T2V denoising step, from its
shapes (batch 1, embedded guidance, no CFG). Matmul operations count 2
per multiply-add.
"""

from __future__ import annotations


def tokens(cfg: dict, latent_shape, text_len: int):
    """(image tokens, joint tokens padded to 128) of latents
    [C, F, H, W] and ``text_len`` text tokens."""
    p = cfg["patch_size"]
    _, f, h, w = latent_shape
    si = (f // p[0]) * (h // p[1]) * (w // p[2])
    return si, -(-(si + text_len) // 128) * 128


def gemm_flop(cfg: dict, latent_shape, text_len: int) -> float:
    """Matmul operations of one step: the embeddings and refiner, every
    double and single block's projections and MLPs, the final layer."""
    d = cfg["hidden_size"]
    mh = int(d * cfg["mlp_ratio"])
    p = cfg["patch_size"]
    si, _ = tokens(cfg, latent_shape, text_len)
    st = text_len
    s = si + st
    # the modulation vectors' GEMMs (one row each) are counted too
    double = (sum(2 * n * (d * 3 * d + d * d + 2 * d * mh) for n in (si, st))
              + 2 * 2 * d * 6 * d)
    single = 2 * s * (d * (3 * d + mh) + (d + mh) * d) + 2 * d * 3 * d
    refiner = (2 * st * cfg["text_states_dim"] * d
               + 2 * (256 * d + d * d) + 2 * (cfg["text_states_dim"] * d
                                              + d * d)
               + cfg["refiner_depth"] * (2 * st * (3 * d * d + d * d
                                                   + 2 * d * mh)
                                         + 2 * d * 2 * d))
    vectors = 2 * (256 * d + d * d) * (2 if cfg["guidance_embed"] else 1) \
        + 2 * (cfg["text_states_dim_2"] * d + d * d)
    embed = 2 * si * cfg["in_channels"] * p[0] * p[1] * p[2] * d + vectors
    head = 2 * si * d * p[0] * p[1] * p[2] * cfg["out_channels"] \
        + 2 * d * 2 * d
    return float(cfg["double_blocks"] * double + cfg["single_blocks"] * single
                 + refiner + embed + head)


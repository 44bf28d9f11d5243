"""Shared helpers for the JAX-vs-torch parity tests (tests/test_torch_*).

Inputs are made with numpy from a seed and handed to both
implementations; weights come from the JAX ``init_hyvideo_params`` and go
through ``jenga_tpu_torch.convert.hyvideo_params_from_jax``.
"""

import jax
import numpy as np
import torch

from jenga_tpu.models.hyvideo import HYVideoConfig as JaxHYConfig
from jenga_tpu.models.hyvideo import init_hyvideo_params
from jenga_tpu_torch.convert import hyvideo_params_from_jax
from jenga_tpu_torch.models.hyvideo import HYVideoConfig, HYVideoDiT

# the slice config of the parity tests: a full HunyuanVideo MMDiT at small
# width and depth, in f32 so the comparison tests the algorithm
SMALL = dict(hidden_size=256, heads_num=2, rope_dim_list=(32, 48, 48),
             double_blocks=1, single_blocks=2, refiner_depth=1,
             text_states_dim=64, text_states_dim_2=24, dtype="float32")

# size=(256, 128), video_length=33 -> latent (9, 16, 32), token grid
# (9, 8, 16) = 1152 video tokens; with 256 text tokens the joint sequence
# is 1408 = 11 blocks, so carving engages: q8 groups {0-7} and {8-10},
# the second a video/text boundary group
LATENT = (16, 9, 16, 32)
TEXT_LEN = 256
TEXT_PAD = 40


def np_params(cfg_kwargs, seed=0, perturb=True):
    """JAX init as a numpy tree, with the zero-init head and refiner
    adaLN perturbed (else the velocity is 0 and refiner blocks are
    identities)."""
    cfg = JaxHYConfig(**cfg_kwargs)
    params = jax.tree.map(np.asarray,
                          init_hyvideo_params(jax.random.PRNGKey(seed), cfg))
    if perturb:
        rng = np.random.default_rng(seed + 100)
        layers = [params["final_layer"]["linear"],
                  params["final_layer"]["adaLN"]] + [
            blk["adaLN"] for blk in params["txt_in"]["blocks"]]
        for lin in layers:
            lin["w"] = (rng.standard_normal(lin["w"].shape) * 0.05).astype(
                lin["w"].dtype)
    return cfg, params


def wan_np_params(cfg_kwargs, seed=0):
    """The Wan JAX init as a numpy tree, its zero-init head perturbed."""
    from jenga_tpu.models.wan import WanConfig, init_wan_params
    cfg = WanConfig(**cfg_kwargs)
    params = jax.tree.map(np.asarray,
                          init_wan_params(jax.random.PRNGKey(seed), cfg))
    w = params["head"]["linear"]["w"]
    params["head"]["linear"]["w"] = (np.random.default_rng(seed).
                                     standard_normal(w.shape) * 0.05
                                     ).astype(w.dtype)
    return cfg, params


def torch_model(cfg_kwargs, params):
    model = HYVideoDiT(HYVideoConfig(**cfg_kwargs))
    model.load_state_dict(hyvideo_params_from_jax(params), strict=True)
    return model


def text_inputs(cfg_kwargs, seed=1):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal(
        (TEXT_LEN, cfg_kwargs["text_states_dim"])).astype(np.float32)
    mask = np.ones((TEXT_LEN,), np.int32)
    mask[TEXT_LEN - TEXT_PAD:] = 0
    txt2 = rng.standard_normal(
        (cfg_kwargs["text_states_dim_2"],)).astype(np.float32)
    return txt, mask, txt2


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def np_vae_tree(init, cfg, seed):
    """A numpy tree of the VAE init ``init(key, cfg)``'s layout
    (``jax.eval_shape``, so nothing of the JAX init runs): weights
    U(+-1/sqrt(fan_in)) (the ``[in, out]`` attention linears: fan_in =
    rows), biases and norm shifts N(0, 0.1), norm scales and gains 1 +
    N(0, 0.1), so every leaf reaches the output (the JAX init zeroes the
    biases and Wan's attention projection)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        lin = "'attn']" in name and s.ndim == 2
        if name.endswith("['w']") and s.ndim > 1:
            fan = s.shape[0] if lin else int(np.prod(s.shape[1:]))
            return (rng.uniform(-1, 1, s.shape) / np.sqrt(fan)).astype(
                np.float32)
        if name.endswith("['b']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)

"""The port's text and image encoders (``jenga_tpu_torch.text``) against
the JAX package's on the same weights and inputs.

Weights come from the JAX ``init_*_params`` at tiny f32 configs and go
through the bridges (``convert.*_params_from_jax``); ids, masks and
images are made with numpy from a seed. Bound: relative L2 <= 1e-5 on
every returned state; the host helpers (templates, crops, the relative
position buckets, the I2V token extraction) must be exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from jenga_tpu import text as jtext
from jenga_tpu.text import clip as jclip
from jenga_tpu.text import llama as jllama
from jenga_tpu.text import llava as jllava
from jenga_tpu.text import t5 as jt5
from jenga_tpu.text import xlm_roberta as jxlmr
from jenga_tpu_torch import convert as C
from jenga_tpu_torch import text as ttext
from jenga_tpu_torch.text import clip as tclip
from jenga_tpu_torch.text import llama as tllama
from jenga_tpu_torch.text import llava as tllava
from jenga_tpu_torch.text import t5 as tt5
from jenga_tpu_torch.text import xlm_roberta as txlmr

from _torch_parity import rel_err

TOL = 1e-5

LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_layers=3, num_heads=4, num_kv_heads=2, dtype="float32")
CLIP_TEXT = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                 num_layers=2, num_heads=2, max_positions=16, eos_token_id=5)
VISION = dict(image_size=28, patch_size=14, hidden_size=32,
              intermediate_size=64, num_layers=3, num_heads=4)
T5 = dict(vocab_size=64, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
          num_layers=2, dtype="float32")
XLMR = dict(vocab_size=64, max_positions=32, dim=16, num_heads=2,
            num_layers=2, ffn_dim=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _module(make, tree, bridge=C.hyvideo_params_from_jax):
    module = make()
    module.load_state_dict(bridge(tree), strict=True)
    return module


def _ids(rng, shape, vocab=64, low=2):
    return rng.integers(low, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def llama():
    jcfg = jllama.LlamaConfig(**LLAMA)
    tree = _np_tree(jllama.init_llama_params(jax.random.PRNGKey(0), jcfg))
    model = _module(lambda: tllama.Llama(tllama.LlamaConfig(**LLAMA)), tree,
                    C.llama_params_from_jax)
    return jcfg, tree, model


@pytest.mark.parametrize("depth", [None, 2, 1])
def test_llama_hidden_states_match_jax(llama, depth):
    """Every returned state at full depth (the last one final-normed) and
    truncated; GQA (4 heads over 2 KV heads); a padded second row."""
    jcfg, tree, model = llama
    rng = np.random.default_rng(1)
    ids = _ids(rng, (2, 11))
    mask = np.ones((2, 11), np.int32)
    mask[1, 7:] = 0
    want = jllama.llama_hidden_states(tree, jcfg, ids, mask,
                                      num_layers=depth)
    got = tllama.llama_hidden_states(model, tllama.LlamaConfig(**LLAMA),
                                     torch.as_tensor(ids),
                                     torch.as_tensor(mask), num_layers=depth)
    assert len(got) == len(want) == (depth or 3) + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g, w) <= TOL
    if depth is None:    # the final norm only at full depth
        assert not np.allclose(np.asarray(got[-1]), np.asarray(
            jllama.llama_hidden_states(tree, jcfg, ids, mask,
                                       num_layers=2)[-1]))


def test_clip_text_encode_matches_jax():
    jcfg = jclip.CLIPTextConfig(**CLIP_TEXT)
    tree = _np_tree(jclip.init_clip_text_params(jax.random.PRNGKey(2), jcfg))
    model = _module(lambda: tclip.CLIPText(tclip.CLIPTextConfig(**CLIP_TEXT)),
                    tree, C.clip_text_params_from_jax)
    rng = np.random.default_rng(3)
    ids = _ids(rng, (3, 9), low=6)
    ids[0, 4] = ids[1, 8] = 5           # EOS; the third row has none
    ids[0, 6] = 5                       # a second EOS: the first one pools
    jh, jp = jclip.clip_text_encode(tree, jcfg, ids)
    th, tp = tclip.clip_text_encode(model, tclip.CLIPTextConfig(**CLIP_TEXT),
                                    torch.as_tensor(ids))
    assert rel_err(th, jh) <= TOL and rel_err(tp, jp) <= TOL
    assert np.array_equal(np.asarray(tp[0]), np.asarray(th[0, 4]))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("mode", [{}, {"use_31_block": True},
                                  {"feature_layer": -2}])
def test_clip_vision_encode_matches_jax(act, mode):
    jcfg = jclip.CLIPVisionConfig(act=act, **VISION)
    tree = _np_tree(jclip.init_clip_vision_params(jax.random.PRNGKey(4),
                                                  jcfg))
    tcfg = tclip.CLIPVisionConfig(act=act, **VISION)
    model = _module(lambda: tclip.CLIPVision(tcfg), tree,
                    C.clip_vision_params_from_jax)
    images = np.random.default_rng(5).standard_normal(
        (2, 3, 28, 28)).astype(np.float32)
    want = jclip.clip_vision_encode(tree, jcfg, images, **mode)
    got = tclip.clip_vision_encode(model, tcfg, torch.as_tensor(images),
                                   **mode)
    assert got.shape == want.shape == (2, 5, 32)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("shared_pos", [False, True])
def test_t5_encode_matches_jax(shared_pos):
    jcfg = jt5.T5Config(shared_pos=shared_pos, **T5)
    tree = _np_tree(jt5.init_t5_params(jax.random.PRNGKey(6), jcfg))
    tcfg = tt5.T5Config(shared_pos=shared_pos, **T5)
    model = _module(lambda: tt5.T5Encoder(tcfg), tree,
                    C.t5_params_from_jax)
    rng = np.random.default_rng(7)
    ids = _ids(rng, (2, 13))
    mask = np.ones((2, 13), np.int32)
    mask[0, 9:] = 0
    want = jt5.t5_encode(tree, jcfg, ids, mask)
    got = tt5.t5_encode(model, tcfg, torch.as_tensor(ids),
                        torch.as_tensor(mask))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= TOL


def test_relative_position_bucket_equals_jax():
    rel = np.arange(300)[None, :] - np.arange(300)[:, None]
    for nb, md, bi in ((32, 128, True), (32, 128, False), (16, 40, True)):
        a = jt5.relative_position_bucket(rel, nb, md, bi)
        b = tt5.relative_position_bucket(rel, nb, md, bi)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_xlm_roberta_encode_matches_jax():
    jcfg = jxlmr.XLMRobertaConfig(**XLMR)
    tree = _np_tree(jxlmr.init_xlm_roberta_params(jax.random.PRNGKey(8),
                                                  jcfg))
    # seeded token types, so the type embedding is not all zeros
    tree["type_embed"] = np.random.default_rng(9).standard_normal(
        tree["type_embed"].shape).astype(np.float32)
    tcfg = txlmr.XLMRobertaConfig(**XLMR)
    model = _module(lambda: txlmr.XLMRoberta(tcfg), tree,
                    C.xlm_roberta_params_from_jax)
    ids = _ids(np.random.default_rng(10), (2, 12))
    ids[1, 8:] = 1                      # pad_id
    want = jxlmr.xlm_roberta_encode(tree, jcfg, ids)
    got = txlmr.xlm_roberta_encode(model, tcfg, torch.as_tensor(ids))
    assert rel_err(got, want) <= TOL


@pytest.fixture(scope="module")
def llava():
    jvis = jclip.CLIPVisionConfig(act="quick_gelu", **VISION)
    jcfg = jllama.LlamaConfig(**LLAMA)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    rng = np.random.default_rng(12)

    def lin(a, b):
        return {"w": rng.standard_normal((a, b)).astype(np.float32) * 0.1,
                "b": rng.standard_normal((b,)).astype(np.float32) * 0.1}

    tree = {"vision": _np_tree(jclip.init_clip_vision_params(keys[0], jvis)),
            "projector": {"fc1": lin(32, 32), "fc2": lin(32, 32)},
            "llm": _np_tree(jllama.init_llama_params(keys[1], jcfg))}
    tvis = tclip.CLIPVisionConfig(act="quick_gelu", **VISION)
    model = _module(lambda: tllava.Llava(tllama.LlamaConfig(**LLAMA), tvis),
                    tree, C.llava_params_from_jax)
    return jcfg, jvis, tree, tvis, model


@pytest.mark.parametrize("depth", [None, 2])
def test_llava_splice_and_encode_match_jax(llava, depth):
    """The splice (the one <image> token becomes the 4 projected patch
    embeddings) and the LM states over the spliced sequence."""
    jcfg, jvis, tree, tvis, model = llava
    rng = np.random.default_rng(13)
    ids = _ids(rng, (1, 10))
    mask = np.ones((1, 10), np.int32)
    mask[0, 8:] = 0
    pix = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    js, jm = jllava.llava_splice(tree, ids, mask, pix, 3, jvis)
    ts, tm = tllava.llava_splice(model, torch.as_tensor(ids),
                                 torch.as_tensor(mask), torch.as_tensor(pix),
                                 3, tvis)
    assert ts.shape == js.shape == (1, 13, 32)
    assert rel_err(ts, js) <= TOL
    assert np.array_equal(np.asarray(tm), np.asarray(jm))
    jst, jmask = jllava.llava_encode(tree, jcfg, ids, mask, pix, 3,
                                     num_layers=depth, vision_cfg=jvis)
    tst, tmask = tllava.llava_encode(model, tllama.LlamaConfig(**LLAMA),
                                     torch.as_tensor(ids),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(pix), 3,
                                     num_layers=depth, vision_cfg=tvis)
    assert len(tst) == len(jst)
    for g, w in zip(tst, jst):
        assert rel_err(g, w) <= TOL


def _i2v_ids(rng, n_text, hits):
    """Unspliced ids of length ``n_text`` with the "\\n\\n" token (271) at
    ``hits``."""
    ids = rng.integers(300, 400, (n_text,)).astype(np.int64)
    ids[list(hits)] = 271
    return ids


@pytest.mark.parametrize("mode", ["video", "image"])
@pytest.mark.parametrize("interleave", [4, 2])
def test_extract_i2v_tokens_equals_jax(mode, interleave):
    """Without token ids; with them (the full template's four "\\n\\n",
    the assistant crop anchored at the last); and truncated (two hits in
    video mode: the sequence end is the anchor)."""
    rng = np.random.default_rng(14)
    n_text = 160
    s = n_text + 575
    hidden = rng.standard_normal((3, s, 4)).astype(np.float32)
    mask = (rng.uniform(size=(3, s)) > 0.2).astype(np.int64)
    ids = np.stack([_i2v_ids(rng, n_text, (10, 40, 90, 140)),
                    _i2v_ids(rng, n_text, (10, 40)),
                    _i2v_ids(rng, n_text, ())])
    cases = [dict(), dict(token_ids=ids)]
    for kw in cases:
        want = jllava.extract_i2v_tokens(hidden, mask, mode, interleave, **kw)
        got = tllava.extract_i2v_tokens(
            torch.as_tensor(hidden), torch.as_tensor(mask), mode, interleave,
            **{k: torch.as_tensor(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.array_equal(g.numpy(), w)


def test_templates_and_crop_equal_jax():
    for name in ("PROMPT_TEMPLATE_IMAGE", "PROMPT_TEMPLATE_VIDEO",
                 "NEGATIVE_PROMPT", "CROP_START"):
        assert getattr(tllama, name) == getattr(jllama, name)
    for name in ("PROMPT_TEMPLATE_I2V_IMAGE", "PROMPT_TEMPLATE_I2V_VIDEO",
                 "NEGATIVE_PROMPT_I2V", "I2V_TEMPLATE_INFO"):
        assert getattr(tllava, name) == getattr(jllava, name)
    rng = np.random.default_rng(15)
    h = rng.standard_normal((2, 120, 4)).astype(np.float32)
    m = rng.integers(0, 2, (2, 120))
    for mode in ("video", "image"):
        assert ttext.apply_hyvideo_template("a cat", mode) == \
            jtext.apply_hyvideo_template("a cat", mode)
        for g, w in zip(ttext.crop_encoder_output(torch.as_tensor(h),
                                                  torch.as_tensor(m), mode),
                        jtext.crop_encoder_output(h, m, mode)):
            assert np.array_equal(g.numpy(), w)
    for a, b in ((tclip.CLIP_L_TEXT, jclip.CLIP_L_TEXT),
                 (tclip.CLIP_H_VISION, jclip.CLIP_H_VISION),
                 (tclip.CLIP_L_VISION_336, jclip.CLIP_L_VISION_336),
                 (tt5.UMT5_XXL, jt5.UMT5_XXL),
                 (tllama.LlamaConfig(), jllama.LlamaConfig()),
                 (txlmr.XLMRobertaConfig(), jxlmr.XLMRobertaConfig())):
        assert vars(a) == vars(b)

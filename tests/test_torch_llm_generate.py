"""KV-cache decoding of the port's llama (``llama_prefill``,
``llama_decode_step``, ``llama_generate``) against the JAX package's on
the same weights and inputs, and Qwen2 / ``attention_bias`` checkpoints
loading into the port.

Weights come from the JAX ``init_llama_params`` at a tiny f32 config
(biases and an untied head added from a numpy seed where a case asks for
them) and go through ``convert.llama_params_from_jax``; ids and masks
are made with numpy from a seed. Bounds: logits within 2e-4 abs / 2e-3
rel (the JAX tests' against HF), caches within 1e-5 relative L2, tokens
and lengths exactly equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jenga_tpu.convert.encoders import convert_llama as jconvert_llama
from jenga_tpu.text import llama as jllama
from jenga_tpu_torch import convert as C
from jenga_tpu_torch.runtime import HunyuanVideoSampler
from jenga_tpu_torch.text import llama as tllama

from _torch_parity import rel_err

ATOL, RTOL = 2e-4, 2e-3
CACHE_TOL = 1e-5
LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
             rms_eps=1e-5, dtype="float32")
CASES = {"gqa": {}, "ragged": {"ragged": True},
         "inputs_embeds": {"ragged": True, "embeds": True},
         "untied_head": {"head": True},
         "qwen2_bias": {"ragged": True, "qkv_bias": True, "head": True},
         "llama_attention_bias": {"qkv_bias": True, "o_bias": True}}


def _tree(case, seed=0):
    """The JAX tree of ``case``: the init, plus biases / a head drawn with
    numpy (the init has neither)."""
    cfg = jllama.LlamaConfig(**LLAMA)
    tree = jax.tree.map(np.asarray,
                        jllama.init_llama_params(jax.random.PRNGKey(seed),
                                                 cfg))
    rng = np.random.default_rng(seed + 10)
    for blk in tree["blocks"]:
        for name in ("q", "k", "v", "o"):
            on = case.get("o_bias") if name == "o" else case.get("qkv_bias")
            if on:
                n = blk[name]["w"].shape[1]
                blk[name]["b"] = (rng.standard_normal(n) * 0.1).astype(
                    np.float32)
    if case.get("head"):
        tree["lm_head"] = {"w": (rng.standard_normal(
            (cfg.hidden_size, cfg.vocab_size)) * 0.2).astype(np.float32)}
    return cfg, tree


def _port(tree):
    sd = C.llama_params_from_jax(tree)
    model = tllama.Llama(tllama.LlamaConfig(**LLAMA),
                         **tllama.bias_flags(sd))
    model.load_state_dict(sd, strict=True)
    return tllama.LlamaConfig(**LLAMA), model


def _prompts(case, seed=1, b=3, s=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LLAMA["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if case.get("ragged"):
        for i, n in enumerate((s, s - 3, 4)[:b]):
            mask[i, n:] = 0
    embeds = None
    if case.get("embeds"):
        embeds = rng.standard_normal(
            (b, s, LLAMA["hidden_size"])).astype(np.float32) * 0.05
    return ids, mask, embeds


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _same_cache(got, want):
    for g, w in zip(got, want):
        for kv in ("k", "v"):
            assert rel_err(g[kv], w[kv]) < CACHE_TOL, kv


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(name):
    """Logits at each sample's last real token, lengths and every layer's
    cache: GQA, a ragged batch, ``inputs_embeds`` (no ids), tied and
    untied head, Qwen2 (q/k/v biases) and HF Llama ``attention_bias``
    (all four)."""
    case = CASES[name]
    jcfg, tree = _tree(case)
    cfg, model = _port(tree)
    ids, mask, embeds = _prompts(case)
    want = jllama.llama_prefill(
        tree, jcfg, None if embeds is not None else ids, mask, max_len=16,
        inputs_embeds=embeds)
    got = tllama.llama_prefill(
        model, cfg, None if embeds is not None else torch.from_numpy(ids),
        torch.from_numpy(mask), max_len=16,
        inputs_embeds=None if embeds is None else torch.from_numpy(embeds))
    _close(got[0], want[0])
    assert got[0].dtype == torch.float32
    assert got[2].tolist() == np.asarray(want[2]).tolist()
    _same_cache(got[1], want[1])
    assert got[1][0]["k"].shape == (3, 16, 2, 8)


def _steps(model, cfg, jcfg, tree, case, n_steps=4):
    """Prefill, then ``n_steps`` decode steps of seeded tokens in both
    packages; each step's logits and caches compared."""
    ids, mask, embeds = _prompts(case)
    max_len = ids.shape[1] + n_steps
    jl, jcache, jlen = jllama.llama_prefill(tree, jcfg, ids, mask,
                                            max_len=max_len)
    tl, tcache, tlen = tllama.llama_prefill(
        model, cfg, torch.from_numpy(ids), torch.from_numpy(mask), max_len)
    cos, sin = jllama.L.rope_table_1d(np.arange(max_len), jcfg.head_dim,
                                      theta=jcfg.rope_theta)
    tcos, tsin = torch.from_numpy(cos), torch.from_numpy(sin)
    rng = np.random.default_rng(7)
    jpos, tpos = jlen, tlen.long()
    out = [tl]
    for _ in range(n_steps):
        tok = rng.integers(0, LLAMA["vocab_size"], ids.shape[0])
        jl, jcache = jllama.llama_decode_step(
            tree, jcfg, jnp.asarray(tok), jpos, jcache, jnp.asarray(cos),
            jnp.asarray(sin))
        tl, tcache = tllama.llama_decode_step(
            model, cfg, torch.from_numpy(tok), tpos, tcache, tcos, tsin)
        _close(tl, jl)
        _same_cache(tcache, jcache)
        jpos, tpos = jpos + 1, tpos + 1
        out.append(tl)
    return out


@pytest.mark.parametrize("name", ["ragged", "qwen2_bias",
                                  "llama_attention_bias"])
def test_decode_steps_match_jax(name):
    """Four decode steps over a ragged (or full) batch: logits and caches
    against JAX after every step."""
    case = CASES[name]
    jcfg, tree = _tree(case)
    cfg, model = _port(tree)
    _steps(model, cfg, jcfg, tree, case)


def test_decode_replaces_pad_entries():
    """The REPLACE trap: in a ragged batch the decode steps write over the
    prefill's pad-token k/v, so the shorter samples' logits equal their
    solo runs over the same tokens (adding would corrupt them)."""
    case = CASES["ragged"]
    jcfg, tree = _tree(case)
    cfg, model = _port(tree)
    ids, mask, _ = _prompts(case)
    max_len = ids.shape[1] + 4
    _, cache, lengths = tllama.llama_prefill(
        model, cfg, torch.from_numpy(ids), torch.from_numpy(mask), max_len)
    cos, sin = tllama._rope_tables(cfg, max_len, "cpu")
    toks = np.random.default_rng(3).integers(0, 64, (4, 3))
    pos, batch = lengths.long(), []
    for tok in toks:
        logits, cache = tllama.llama_decode_step(
            model, cfg, torch.from_numpy(tok), pos, cache, cos, sin)
        batch.append(logits)
        pos = pos + 1
    for i in (1, 2):
        n = int(mask[i].sum())
        _, solo, slen = tllama.llama_prefill(
            model, cfg, torch.from_numpy(ids[i:i + 1, :n]),
            torch.ones((1, n), dtype=torch.int32), max_len)
        spos = slen.long()
        for t, tok in enumerate(toks):
            logits, solo = tllama.llama_decode_step(
                model, cfg, torch.from_numpy(tok[i:i + 1]), spos, solo, cos,
                sin)
            assert rel_err(batch[t][i], logits[0]) < 1e-5, (i, t)
            spos = spos + 1


@pytest.mark.parametrize("name", ["ragged", "inputs_embeds", "qwen2_bias",
                                  "llama_attention_bias"])
def test_generate_greedy_matches_jax(name):
    """Greedy tokens equal JAX's, with EOS stopping one sample early."""
    case = CASES[name]
    jcfg, tree = _tree(case)
    cfg, model = _port(tree)
    ids, mask, embeds = _prompts(case)
    jids = None if embeds is not None else jnp.asarray(ids)
    tids = None if embeds is not None else torch.from_numpy(ids)
    want = jllama.llama_generate(tree, jcfg, jids, jnp.asarray(mask),
                                 max_new_tokens=6, inputs_embeds=embeds)
    eos = want[1][2]        # stops sample 1 after two tokens
    want = jllama.llama_generate(tree, jcfg, jids, jnp.asarray(mask),
                                 max_new_tokens=6, eos_token_id=eos,
                                 inputs_embeds=embeds)
    got = tllama.llama_generate(
        model, cfg, tids, torch.from_numpy(mask), max_new_tokens=6,
        eos_token_id=eos,
        inputs_embeds=None if embeds is None else torch.from_numpy(embeds))
    assert got == want
    assert len(got[1]) <= 2


def test_generate_sampled_with_jax_draws():
    """At temperature 0.7 the port fed JAX's own Gumbel draws (key 0,
    split each step, as ``jax.random.categorical`` makes them) gives
    JAX's tokens."""
    case = CASES["qwen2_bias"]
    jcfg, tree = _tree(case)
    cfg, model = _port(tree)
    ids, mask, _ = _prompts(case)
    want = jllama.llama_generate(tree, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), max_new_tokens=8,
                                 temperature=0.7, key=jax.random.PRNGKey(0))
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(8):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.gumbel(
            sub, (3, LLAMA["vocab_size"]))))
    got = tllama.llama_generate(
        model, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
        max_new_tokens=8, temperature=0.7,
        noise=lambda t, shape: torch.from_numpy(draws[t]))
    assert got == want
    greedy = jllama.llama_generate(tree, jcfg, jnp.asarray(ids),
                                   jnp.asarray(mask), max_new_tokens=8)
    assert got != greedy


def test_generate_generator_is_reproducible():
    """The port's own draws come from the generator alone: one seed gives
    one output, another seed another, the global RNG is not drawn from,
    and without a generator it is greedy (JAX without a key)."""
    case = CASES["ragged"]
    _, tree = _tree(case)
    cfg, model = _port(tree)
    ids, mask, _ = _prompts(case)
    args = (model, cfg, torch.from_numpy(ids), torch.from_numpy(mask))

    def run(seed):
        return tllama.llama_generate(
            *args, max_new_tokens=8, temperature=1.5,
            generator=torch.Generator().manual_seed(seed))

    state = torch.get_rng_state()
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(state, torch.get_rng_state())
    assert a == b and a != c
    greedy = tllama.llama_generate(*args, max_new_tokens=8)
    assert tllama.llama_generate(*args, max_new_tokens=8,
                                 temperature=1.5) == greedy


def _hf_lm(kind, tmp_path):
    """A tiny HF causal LM saved to a directory: Qwen2 (q/k/v biases, no
    o bias, untied) or Llama with ``attention_bias`` (all four)."""
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, tie_word_embeddings=False)
    torch.manual_seed(5)
    if kind == "qwen2":
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            rope_theta=1000000.0, rms_norm_eps=1e-6, **common))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=True,
            **common))
    model.eval().save_pretrained(str(tmp_path))
    return model


@pytest.mark.parametrize("kind", ["qwen2", "llama_attention_bias"])
def test_hf_checkpoint_loads_strictly(kind, tmp_path):
    """The Qwen2 fault: a Qwen2 tree has q/k/v biases and no o bias, and
    the port's text-encoder loader (``_load_llm``: convert, build on the
    meta device, strict load) must take it as it takes HF Llama's four
    biases. The loaded module's prefill logits equal JAX's on the same
    state dict, and HF's own."""
    hf = _hf_lm(kind, tmp_path)
    sd = hf.state_dict()
    _, cfg, model = HunyuanVideoSampler._load_llm(str(tmp_path), "cpu")
    blk = model.blocks[0]
    assert blk.q.b is not None and blk.k.b is not None
    assert (blk.o.b is not None) == (kind != "qwen2")
    assert model.lm_head is not None
    theta = json.loads((tmp_path / "config.json").read_text())["rope_theta"]
    assert cfg.rope_theta == theta
    jcfg = jllama.LlamaConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "rope_theta", "rms_eps")},
        dtype="float32")
    jtree = jax.tree.map(jnp.asarray, jconvert_llama(sd, jcfg))
    assert ("b" in jtree["blocks"][0]["o"]) == (kind != "qwen2")
    ids = np.random.default_rng(4).integers(0, 64, (2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    want = jllama.llama_prefill(jtree, jcfg, ids, mask, max_len=12)[0]
    got = tllama.llama_prefill(model, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), max_len=12)[0]
    _close(got, want)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long()).logits
    np.testing.assert_allclose(got[0].numpy(), ref[0, -1].numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), ref[1, 4].numpy(),
                               atol=ATOL, rtol=RTOL)

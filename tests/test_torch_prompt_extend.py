"""The port's prompt expanders (``jenga_tpu_torch.text.prompt_extend``)
against the JAX package's: the system prompts and the two copied classes
line for line, ``APIExpander`` over a stub transport (never the network),
and the local expanders on tiny HF directories built with
``transformers`` and a ``tokenizers`` WordLevel (the same directories
loaded by both packages, f32, greedy): the same text out.
"""

import inspect
import json
import re
from dataclasses import asdict

import numpy as np
import pytest
import torch

from jenga_tpu.text import prompt_extend as jpe
from jenga_tpu_torch.text import prompt_extend as tpe

import _torch_ckpt as K
from _torch_parity import rel_err

PROMPTS = ["T2V_EXTEND_SYSTEM_PROMPT", "I2V_EXTEND_SYSTEM_PROMPT",
           "VL_EXTEND_SYSTEM_PROMPT", "REWRITE_NORMAL_SYSTEM_PROMPT",
           "REWRITE_MASTER_SYSTEM_PROMPT"]


@pytest.mark.parametrize("name", PROMPTS)
def test_system_prompt_is_jax(name):
    assert getattr(tpe, name) == getattr(jpe, name)
    assert name in tpe.__all__


@pytest.mark.parametrize("cls", ["PromptExpander", "APIExpander"])
def test_copied_class_is_the_original(cls):
    """``PromptExpander`` and ``APIExpander`` are the original's source,
    the reference's paths in docstrings written as names."""
    orig = re.sub(r"`/\w+/reference/", "the reference's `",
                  inspect.getsource(getattr(jpe, cls)))
    assert inspect.getsource(getattr(tpe, cls)) == orig


class _Transport:
    """A recording transport answering ``reply`` after ``fail`` raised
    attempts."""

    def __init__(self, reply, fail=0):
        self.reply, self.fail, self.calls = reply, fail, []

    def __call__(self, url, headers, body, timeout):
        self.calls.append((url, dict(headers), json.loads(body), timeout))
        if len(self.calls) <= self.fail:
            raise OSError("connection reset")
        return json.dumps(self.reply).encode()


DIALECTS = {
    "openai": {"choices": [{"message": {"content": "  expanded  "}}]},
    "dashscope_choices": {"output": {"choices": [
        {"message": {"content": "dc"}}]}},
    "dashscope_text": {"output": {"text": "ds text"}},
}


def _both(monkeypatch, reply, fail=0, image=None, mode="t2v", **kw):
    """The same call through each package's API expander: (result,
    transport calls) per package; ``time.sleep`` stubbed, its delays
    recorded."""
    out = {}
    for name, mod in (("jax", jpe), ("port", tpe)):
        sleeps = []
        monkeypatch.setattr("time.sleep", sleeps.append)
        tr = _Transport(reply, fail)
        exp = mod.APIExpander(transport=tr, **kw)
        try:
            res = mod.PromptExpander(chat_fn=exp, mode=mode)(
                "a cat", image=image)
        except RuntimeError as e:
            res = ("raised", str(e))
        out[name] = (res, tr.calls, sleeps, exp.url, exp.api_key)
    return out


@pytest.mark.parametrize("dialect", list(DIALECTS))
def test_api_expander_dialects_match_jax(monkeypatch, dialect):
    """Both response dialects: the same url, headers, body, timeout and
    result as JAX's."""
    out = _both(monkeypatch, DIALECTS[dialect], model="qwen-max",
                url="https://x/v1/chat", api_key="sk-test", timeout=7.0)
    assert out["port"] == out["jax"]
    res, calls = out["port"][:2]
    assert res == {"openai": "expanded", "dashscope_choices": "dc",
                   "dashscope_text": "ds text"}[dialect]
    assert calls[0][1]["Authorization"] == "Bearer sk-test"


@pytest.mark.parametrize("fail,retries", [(1, 3), (3, 4), (2, 2)])
def test_api_expander_retries_match_jax(monkeypatch, fail, retries):
    """A failing transport: the same number of attempts, the same backoff
    delays, and past ``retries`` the same error."""
    out = _both(monkeypatch, DIALECTS["openai"], fail=fail,
                retries=retries)
    assert out["port"] == out["jax"]
    res, calls, sleeps = out["port"][:3]
    assert len(calls) == min(fail + 1, retries)
    if fail >= retries:
        assert res[0] == "raised" and f"after {retries} attempts" in res[1]


@pytest.mark.parametrize("env", [
    {}, {"PROMPT_EXTEND_API_URL": "https://e/v1", "DASH_API_KEY": "k1"},
    {"DASHSCOPE_API_KEY": "k2", "OPENAI_API_KEY": "k3"},
    {"OPENAI_API_KEY": "k3"}])
def test_api_expander_env_matches_jax(monkeypatch, env):
    """The endpoint and key from the environment, in JAX's order."""
    for var in ("PROMPT_EXTEND_API_URL", "DASH_API_KEY",
                "DASHSCOPE_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    out = _both(monkeypatch, DIALECTS["openai"])
    assert out["port"] == out["jax"]
    assert out["port"][3] == env.get(
        "PROMPT_EXTEND_API_URL",
        "https://dashscope.aliyuncs.com/compatible-mode/v1/chat/completions")


@pytest.mark.parametrize("kind", ["png_path", "jpg_path", "array_uint8",
                                  "array_float"])
def test_api_expander_image_part_matches_jax(monkeypatch, tmp_path, kind):
    """The data-URL image part, byte for byte, for a file path and for a
    [3, H, W] array, inside the same multimodal body."""
    from PIL import Image
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (3, 6, 5)).astype(np.uint8)
    if kind.endswith("path"):
        image = str(tmp_path / f"img.{kind[:3]}")
        Image.fromarray(np.moveaxis(arr, 0, -1)).save(image)
    else:
        image = arr if kind == "array_uint8" else arr.astype(
            np.float32) * 1.3
    out = _both(monkeypatch, DIALECTS["openai"], image=image, mode="vl")
    assert out["port"] == out["jax"]
    content = out["port"][1][0][2]["messages"][1]["content"]
    assert content[1]["image_url"]["url"].startswith(
        "data:image/" + ("jpeg" if kind == "jpg_path" else "png"))
    assert tpe.APIExpander._image_part(image) == \
        jpe.APIExpander._image_part(image)


# ------------------------------------------------------- local expanders

WORDS = {"<pad>": 0, "<unk>": 1, **{f"w{i}": i for i in range(2, 62)}}


def _lm_dir(path, kind):
    """A tiny HF LM directory with a WordLevel tokenizer (EOS = id 0):
    Qwen2 (q/k/v biases, rope_theta 1e6, untied head) or plain Llama."""
    import transformers
    common = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2)
    torch.manual_seed(11)
    if kind == "qwen2":
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            rope_theta=1000000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=False, **common))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **common))
    model.eval().save_pretrained(str(path))
    K.make_tokenizer(str(path), WORDS)
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    (path / "tokenizer_config.json").write_text(json.dumps(
        {**cfg, "eos_token": "<pad>"}))
    return path


@pytest.mark.parametrize("kind", ["qwen2", "llama"])
@pytest.mark.parametrize("mode", ["t2v", "rewrite"])
def test_local_llm_expander_matches_jax(tmp_path, kind, mode):
    """The same directory through both packages' ``LocalLLMExpander``
    (f32): the config read alike (the Qwen2 dir's rope_theta and biases),
    the same text out of ``PromptExpander``."""
    path = _lm_dir(tmp_path, kind)
    jexp = jpe.LocalLLMExpander(str(path), max_new_tokens=6,
                                dtype="float32")
    texp = tpe.LocalLLMExpander(str(path), max_new_tokens=6,
                                dtype="float32", device="cpu")
    assert asdict(texp.cfg) == asdict(jexp.cfg)
    assert texp.cfg.rope_theta == (1e6 if kind == "qwen2" else 10000.0)
    blk = texp.model.blocks[0]
    assert (blk.q.b is not None) == (kind == "qwen2")
    assert blk.o.b is None
    user = "w3 w5 w7 w11"
    want = jpe.PromptExpander(chat_fn=jexp, mode=mode)(user)
    got = tpe.PromptExpander(chat_fn=texp, mode=mode)(user)
    print(f"{kind} {mode}: {got!r}")
    assert got == want and got != user


def _llava_dir(path):
    """A tiny llava directory (``_torch_ckpt.hf_llava``: CLIP 28px, a
    3-layer llama) with ``<image>`` (id 63) as a special token."""
    K.hf_llava(seed=12, image_token=63).save_pretrained(str(path))
    K.make_tokenizer(str(path), {**WORDS, "<image>": 63},
                     special=("<image>",))
    cfg = json.loads((path / "tokenizer_config.json").read_text())
    (path / "tokenizer_config.json").write_text(json.dumps(
        {**cfg, "eos_token": "<pad>"}))
    return path


def _image(seed=3, shape=(3, 37, 53)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_local_vl_expander_matches_jax(tmp_path):
    """A llava directory through both ``LocalVLExpander``s (f32): the
    image spliced at the ``<image>`` token, the same text out; the image
    as an array and as a file."""
    from PIL import Image
    path = _llava_dir(tmp_path / "llava")
    jexp = jpe.LocalVLExpander(str(path), max_new_tokens=6, dtype="float32")
    texp = tpe.LocalVLExpander(str(path), max_new_tokens=6, dtype="float32",
                               device="cpu")
    assert asdict(texp.cfg) == asdict(jexp.cfg)
    assert asdict(texp.vision_cfg) == asdict(jexp.vision_cfg)
    assert texp.image_token_id == jexp.image_token_id == 63
    img = _image()
    file = str(tmp_path / "img.png")
    Image.fromarray((np.moveaxis(img, 0, -1) * 255).astype(np.uint8)).save(
        file)
    for image in (img, file):
        want = jpe.PromptExpander(chat_fn=jexp, mode="vl")("w3 w4",
                                                           image=image)
        got = tpe.PromptExpander(chat_fn=texp, mode="vl")("w3 w4",
                                                          image=image)
        print(f"vl: {got!r}")
        assert got == want


def test_local_vl_expander_errors_are_jax(tmp_path):
    """No image, and a prompt whose template holds no ``<image>`` token:
    JAX's messages."""
    path = _llava_dir(tmp_path / "llava")
    texp = tpe.LocalVLExpander(str(path), max_new_tokens=2, dtype="float32",
                               device="cpu")
    with pytest.raises(ValueError, match="requires an image; use "
                       "LocalLLMExpander for text-only expansion"):
        texp("sys", "user")
    texp._image_token_id = 62
    with pytest.raises(ValueError, match=r"exactly one <image> token "
                       r"\(id 62\), found 0"):
        texp("sys", "user", image=_image())


@pytest.mark.parametrize("shape, rel, abs_", [
    ((3, 28, 28), 1e-6, 1e-6),      # the tower's size: no resize
    ((3, 20, 16), 1e-6, 5e-6),      # upscale
    ((3, 37, 53), 1e-6, 5e-6),      # downscale
    ((3, 300, 200), 2e-6, 5e-6)])   # 10x downscale
def test_pixel_values_match_jax(tmp_path, shape, rel, abs_):
    """``_pixel_values``: the resize to the tower's size and CLIP's
    normalization, against JAX's. At the tower's size both are exact, and
    held to 1e-6; a resize (torch's antialiased bicubic against
    ``jax.image.resize``) is a few float32 ulps apart elementwise, 1.3e-6
    at most, and 1.5e-6 relative L2 at a 10x downscale, so only that
    case has the looser relative bound."""
    path = _llava_dir(tmp_path / "llava")
    jexp = jpe.LocalVLExpander(str(path), max_new_tokens=1, dtype="float32")
    texp = tpe.LocalVLExpander(str(path), max_new_tokens=1, dtype="float32",
                               device="cpu")
    img = _image(seed=sum(shape), shape=shape)
    want = np.asarray(jexp._pixel_values(img))
    got = texp._pixel_values(img)
    assert tuple(got.shape) == want.shape == (1, 3, 28, 28)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < rel
    assert np.abs(got.numpy() - want).max() < abs_


def test_local_expander_tokenizer_slot(tmp_path):
    """The tokenizer is loaded on first use, and a caller's tokenizer in
    the slot is used instead (the card has no ``transformers``)."""
    path = _lm_dir(tmp_path, "qwen2")
    texp = tpe.LocalLLMExpander(str(path), max_new_tokens=3,
                                dtype="float32", device="cpu")
    assert texp._tok is None

    class Tok:
        eos_token_id = None

        def apply_chat_template(self, *a, **k):
            raise ValueError("no template")

        def encode(self, text):
            self.text = text
            return [5, 6, 7]

        def decode(self, ids, skip_special_tokens=False):
            return " ".join(f"w{i}" for i in ids)

    texp.tok = Tok()
    out = texp("sys", "w1")
    assert texp.tok.text == "sys\n\nw1\n"
    assert len(out.split()) == 3

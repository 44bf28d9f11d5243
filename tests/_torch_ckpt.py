"""Synthetic checkpoints in the reference's layouts for the port's
conversion and loading tests (tests/test_torch_convert.py,
tests/test_torch_runtime_prompt.py).

The builders of the reference's own module layouts (HunyuanVideo's and
Wan's DiTs and VAEs, Wan's T5 and CLIP) are the smoke test's
(``chip_smoke.py``, pure torch: ``{key: tensor}`` from a seeded
generator at a given config); the HF layouts come from ``transformers``
models built at tiny configs, and the tokenizer is a ``tokenizers``
WordLevel over whitespace, saved as an HF fast tokenizer directory.
"""

import json
import os

import torch

from chip_smoke import (clip_wan_ref, hy_dit_ref, hyvae_ref,  # noqa: F401
                        umt5_wan_ref, wan_dit_ref, wanvae_ref)

# tiny configs of the port's (and the JAX package's) dataclasses
HY_TINY = dict(hidden_size=32, heads_num=2, double_blocks=1,
               single_blocks=1, rope_dim_list=(4, 6, 6), text_states_dim=24,
               text_states_dim_2=12, refiner_depth=1, dtype="float32")
WAN_TINY = dict(dim=32, ffn_dim=64, freq_dim=16, num_heads=2, num_layers=2,
                text_dim=24, text_len=16, dtype="float32")
T5_TINY = dict(vocab_size=64, dim=24, dim_attn=24, dim_ffn=48, num_heads=2,
               num_layers=2, dtype="float32")
CLIP_H_TINY = dict(image_size=28, patch_size=14, hidden_size=32,
                   intermediate_size=64, num_layers=3, num_heads=4)
XLMR_TINY = dict(vocab_size=64, max_positions=32, dim=16, num_heads=2,
                 num_layers=2, ffn_dim=32)


# ------------------------------------------------------------ HF layouts

VOCAB = {"<pad>": 0, "<unk>": 1, "a": 2, "cat": 3, "walks": 4, "on": 5,
         "the": 6, "grass": 7, "dog": 8, "runs": 9}


def make_tokenizer(dirpath, vocab=None, special=()):
    """An offline HF fast tokenizer: WordLevel over whitespace, padded with
    id 0; ``special`` tokens survive pre-tokenization."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    os.makedirs(dirpath, exist_ok=True)
    tok = Tokenizer(models.WordLevel(vocab or VOCAB, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    if special:
        tok.add_special_tokens(list(special))
    tok.enable_padding(pad_id=0, pad_token="<pad>")
    tok.save(os.path.join(dirpath, "tokenizer.json"))
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "<pad>", "unk_token": "<unk>",
                   "model_max_length": 4096}, f)


def hf_llama(seed=0, causal_lm=False):
    from transformers import LlamaConfig, LlamaForCausalLM, LlamaModel
    torch.manual_seed(seed)
    cfg = LlamaConfig(vocab_size=64, hidden_size=24, intermediate_size=48,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2, rms_norm_eps=1e-5)
    return (LlamaForCausalLM if causal_lm else LlamaModel)(cfg).eval()


def hf_clip_text(seed=0):
    from transformers import CLIPTextConfig, CLIPTextModel
    torch.manual_seed(seed)
    return CLIPTextModel(CLIPTextConfig(
        vocab_size=64, hidden_size=12, intermediate_size=24,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=77, eos_token_id=0)).eval()


def hf_clip_vision(seed=0):
    from transformers import CLIPVisionConfig, CLIPVisionModel
    torch.manual_seed(seed)
    return CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14)).eval()


def hf_llava(seed=0, image_token=63):
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)
    torch.manual_seed(seed)
    vis = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=4,
                           image_size=28, patch_size=14)
    txt = LlamaConfig(vocab_size=64, hidden_size=24, intermediate_size=48,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2, rms_norm_eps=1e-5)
    return LlavaForConditionalGeneration(LlavaConfig(
        vision_config=vis, text_config=txt,
        image_token_index=image_token)).eval()


def hf_umt5(seed=0):
    from transformers import UMT5Config, UMT5EncoderModel
    torch.manual_seed(seed)
    return UMT5EncoderModel(UMT5Config(
        vocab_size=64, d_model=24, d_kv=12, d_ff=48, num_layers=2,
        num_heads=2, relative_attention_num_buckets=32)).eval()


LLAVA_VIS = dict(image_size=28, patch_size=14, hidden_size=32,
                 intermediate_size=64, num_layers=3, num_heads=4,
                 act="quick_gelu")
LLAMA_HF = dict(vocab_size=64, hidden_size=24, intermediate_size=48,
                num_layers=3, num_heads=4, num_kv_heads=2)

"""jenga_tpu_torch: the PyTorch + CUDA port of ``jenga_tpu``.

Runs the HunyuanVideo T2V and Wan2.1 T2V 1.3B Jenga-Base carving paths
(curve reorder, pooled-QK top-p block selection, block-sparse attention,
fixed-list and TeaCache step skipping) on an NVIDIA Hopper GPU. Attention
runs on two hand-written sm_90a CUDA kernels, block-sparse
(``csrc/block_sparse_attn.cu``) and dense (``csrc/dense_attn.cu``); every
other op is plain PyTorch, among them the two video VAEs (``codec/``:
HunyuanVideo's tiled causal 3-D VAE, Wan2.1's streamed frame by frame)
and the text and image encoders (``text/``). ``convert/`` loads the
reference's checkpoint directories (``from_pretrained``). The CLI runs
prompt lists and VBench batches with resume (``batch.py``) and extends
prompts with a local LM or llava decoded through a KV cache, or a chat
API (``text/prompt_extend.py``): with these the port does all that the
JAX package does, less the TPU-only modules ``ROADMAP.md`` lists.
The probe tools (``tools/``) time four more hand-written kernels
(``csrc/attn_probe.cu``, ``csrc/block_pool.cu``,
``csrc/cross_attn_resident.cu``) that no main path runs. The numpy-only
host modules (curves, skip schedules, option validation, video output,
logging, batching) are copies of the JAX package's, held equal to them by the tests: this
package imports neither JAX nor ``jenga_tpu``.
"""

__version__ = "0.2.0"

__all__ = ["HunyuanVideoSampler", "WanSampler"]


def __getattr__(name):
    # lazy: importing the package must not pull torch/models eagerly
    if name in __all__:
        from . import runtime
        return getattr(runtime, name)
    raise AttributeError(name)

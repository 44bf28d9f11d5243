"""jenga_tpu_torch: the PyTorch + CUDA port of ``jenga_tpu``.

Runs the HunyuanVideo T2V and Wan2.1 T2V 1.3B Jenga-Base carving paths
(curve reorder, pooled-QK top-p block selection, block-sparse attention,
fixed-list and TeaCache step skipping) on an NVIDIA Hopper GPU. Attention
runs on two hand-written sm_90a CUDA kernels, block-sparse
(``csrc/block_sparse_attn.cu``) and dense (``csrc/dense_attn.cu``); every
other op is plain PyTorch. The numpy-only host modules (curves, skip
schedules, option validation) are imported from ``jenga_tpu`` so both
packages share one source for curve orders and skip lists. This package
never imports JAX.
"""

__version__ = "0.2.0"

__all__ = ["HunyuanVideoSampler", "WanSampler"]


def __getattr__(name):
    # lazy: importing the package must not pull torch/models eagerly
    if name in __all__:
        from . import runtime
        return getattr(runtime, name)
    raise AttributeError(name)

"""The card's peaks and the roofline bound of a kernel.

Frozen from ``chip_smoke.py``'s ``bound`` / ``attn_bound`` (PERF.md's
kernel table): the least time the card could take is the larger of the
operations over the bf16 tensor-core peak and the bytes over the HBM
bandwidth, each operand read once and each output written once.
Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its 700 W
limit).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12     # bf16 tensor cores
PEAK_BYTES = 3.35e12    # HBM3
TILE_FLOP = 4 * 128 ** 3    # QK^T and PV of one 128x128 tile at d = 128


def bound_s(flop: float, nbytes: float) -> float:
    """Seconds the card needs at least for ``flop`` operations moving
    ``nbytes`` bytes."""
    return max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention_tiles_flop(tiles: int, head_dim: int = 128) -> float:
    """Operations of ``tiles`` 128 x 128 (query, key) tiles: QK^T and PV."""
    return tiles * 4 * 128 * 128 * head_dim


def attention_bytes(q_numel: int, kv_numel: int, itemsize: int = 2) -> int:
    """q read and o written once, k and v read once."""
    return 2 * (q_numel + kv_numel) * itemsize


def dense_attention(batch: int, heads: int, sq: int, skv: int,
                    head_dim: int = 128, itemsize: int = 2):
    """(operations, bytes) of dense attention of sq queries over skv keys."""
    flop = 4.0 * batch * heads * sq * skv * head_dim
    return flop, attention_bytes(batch * heads * sq * head_dim,
                                 batch * heads * skv * head_dim, itemsize)

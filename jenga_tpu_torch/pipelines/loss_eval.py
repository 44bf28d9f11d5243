"""Latent-space fidelity harness.

Port of ``jenga_tpu/pipelines/loss_eval.py``: the per-step MSE between two
denoising trajectories, the carved-vs-dense final-latent report, and the
``.npz`` trajectory format (``step_00000``, ``step_00001``, ... latent
arrays in f32 and a ``meta`` array holding a UTF-8 JSON blob as uint8),
which both packages write and read alike. The port has no VAE yet, so
every report compares latents; ``carving_fidelity_report`` calls the
pipeline's own ``generate`` signature (HunyuanVideo's text triple, Wan's
prompt pair) and ``generate_i2v`` for the I2V pipelines.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["trajectory_mse", "carving_fidelity_report", "save_trajectory",
           "load_trajectory", "reference_fidelity_report", "fidelity_row"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def save_trajectory(path: str, latents, meta: dict | None = None) -> None:
    """Write a denoising trajectory to ``.npz``: one ``step_%05d`` f32
    array per step and the ``meta`` dict as uint8 JSON."""
    arrays = {f"step_{i:05d}": _f32(x) for i, x in enumerate(latents)}
    arrays["meta"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                   dtype=np.uint8)
    np.savez(path, **arrays)


def load_trajectory(path: str):
    """(list of latent arrays in step order, meta dict)."""
    with np.load(path) as data:
        steps = sorted(k for k in data.files if k.startswith("step_"))
        meta = {}
        if "meta" in data.files:
            meta = json.loads(bytes(data["meta"].tobytes()).decode())
        return [data[k] for k in steps], meta


def trajectory_mse(latent_trace, reference_trace) -> list[float]:
    """Per-step MSE between two trajectories (lists of arrays or
    tensors), in f32."""
    return [float(np.mean(np.square(_f32(a) - _f32(b))))
            for a, b in zip(latent_trace, reference_trace)]


def reference_fidelity_report(latent_trace, reference_path: str) -> dict:
    """Per-step MSE of a recorded run against a trajectory file, with the
    last compared step's relative error."""
    ref, meta = load_trajectory(reference_path)
    n = min(len(latent_trace), len(ref))
    losses = trajectory_mse(latent_trace[:n], ref[:n])
    final = losses[-1] if losses else float("nan")
    ref_last = _f32(ref[n - 1])
    ours_last = _f32(latent_trace[n - 1])
    rel = float(np.linalg.norm(ours_last - ref_last)
                / (np.linalg.norm(ref_last) + 1e-8))
    return {"per_step_mse": losses, "final_mse": final,
            "final_relative_error": rel, "steps_compared": n,
            "meta": meta}


def fidelity_row(got, want) -> dict:
    """Final-latent MSE and relative error of ``got`` against ``want``
    (f32 on the host), with ``want``'s norm."""
    got, want = _f32(got), _f32(want)
    diff = got - want
    norm = float(np.linalg.norm(want))
    return {"final_mse": float(np.mean(np.square(diff))),
            "relative_error": float(np.linalg.norm(diff) / (norm + 1e-8)),
            "dense_norm": norm}


def carving_fidelity_report(pipeline, inputs, carving_opts,
                            dense_opts) -> dict:
    """Run one seed through a carved and a dense configuration and report
    the final latents' MSE and relative error. ``inputs`` are the
    pipeline's positional inputs before the options: ``(context,
    context_null)`` for Wan T2V, ``(text_states, text_mask,
    text_states_2)`` for HunyuanVideo, and for the I2V pipelines the
    leading arguments of ``generate_i2v``. Both arms stay in latent space
    (``decode=False``), as in the JAX harness. (The JAX function's
    ``make_opts`` and ``sample_steps`` are unused there and not taken.)"""
    gen = (pipeline.generate_i2v if hasattr(pipeline, "generate_i2v")
           else pipeline.generate)
    carved = gen(*inputs, carving_opts, decode=False)
    dense = gen(*inputs, dense_opts, decode=False)
    return fidelity_row(carved, dense)

# Copy of jenga_tpu/train/dataset.py, kept so that the port never imports it.
"""Latent-video training dataset (pre-encoded latents + prompts).

Counterpart of the reference ``VideoDataset``
(the reference's `hyvideo_i2v/dataset/video_loader.py:13-184`): per-clip
JSON metadata (``video_id``, ``latent_shape``, ``prompt``,
``npy_save_path``) pointing at pre-encoded VAE latents, grouped into
same-shape buckets so every batch is shape-static (the XLA requirement
that replaces the reference's per-resolution collate)."""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["LatentDataset"]


class LatentDataset:
    """Reads the reference's data-json layout; batches bucket by latent
    shape so jitted train steps never recompile mid-epoch."""

    def __init__(self, data_jsons_path: str, uncond_p: float = 0.0):
        self.items = []
        self.uncond_p = uncond_p
        for name in sorted(os.listdir(data_jsons_path)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(data_jsons_path, name),
                      encoding="utf-8-sig") as f:
                data = json.load(f)
            self.items.append({
                "video_id": data["video_id"],
                "latent_shape": tuple(data["latent_shape"]),
                "prompt": data.get("prompt", ""),
                "npy_save_path": data["npy_save_path"],
            })
        if not self.items:
            raise FileNotFoundError(f"no .json metadata in "
                                    f"{data_jsons_path}")

    def __len__(self):
        return len(self.items)

    def buckets(self):
        """{latent_shape: [item, ...]} — one bucket per static shape."""
        out = {}
        for item in self.items:
            out.setdefault(item["latent_shape"], []).append(item)
        return out

    def batches(self, batch_size: int, rng: np.random.Generator,
                drop_remainder: bool = True):
        """Yield {"latents": [B, ...], "prompts": [str], "ids": [str]}
        batches, shuffled within shape buckets."""
        for shape, items in self.buckets().items():
            order = rng.permutation(len(items))
            for start in range(0, len(items), batch_size):
                sel = order[start:start + batch_size]
                if drop_remainder and len(sel) < batch_size:
                    continue
                lat = np.stack([np.load(items[i]["npy_save_path"])
                                for i in sel]).astype(np.float32)
                prompts = [
                    "" if rng.random() < self.uncond_p
                    else items[i]["prompt"] for i in sel]
                yield {"latents": lat,
                       "prompts": prompts,
                       "ids": [items[i]["video_id"] for i in sel]}

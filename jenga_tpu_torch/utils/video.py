# Copy of jenga_tpu/utils/video.py, kept so that the port never imports it.
"""Video/image IO: save generated tensors as mp4/gif/png.

Counterpart of the reference's `save_videos_grid`
(the reference's `hyvideo/utils/file_utils.py:47-80`) and
``cache_video/cache_image`` (the reference's `wan/utils/utils.py:23-93`).
Uses imageio; falls back from libx264 mp4 to GIF when no ffmpeg backend is
present in the environment.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["to_uint8_frames", "save_video", "save_image", "make_grid"]


def to_uint8_frames(video, value_range=(-1.0, 1.0)):
    """[C, F, H, W] (or [F, H, W, C]) float video -> [F, H, W, C] uint8."""
    v = np.asarray(video, np.float32)
    if v.ndim != 4:
        raise ValueError(f"expected 4-D video, got shape {v.shape}")
    if v.shape[0] in (1, 3) and v.shape[-1] not in (1, 3):
        v = v.transpose(1, 2, 3, 0)  # C,F,H,W -> F,H,W,C
    lo, hi = value_range
    v = np.clip((v - lo) / (hi - lo), 0.0, 1.0)
    return (v * 255.0 + 0.5).astype(np.uint8)


def make_grid(videos, n_cols: int | None = None, padding: int = 2):
    """Stack a batch of [C, F, H, W] videos into one grid video."""
    vids = [to_uint8_frames(v) for v in videos]
    n = len(vids)
    n_cols = n_cols or int(np.ceil(np.sqrt(n)))
    n_rows = int(np.ceil(n / n_cols))
    f, h, w, c = vids[0].shape
    grid = np.zeros((f, n_rows * (h + padding) - padding,
                     n_cols * (w + padding) - padding, c), np.uint8)
    for i, v in enumerate(vids):
        r, cidx = divmod(i, n_cols)
        grid[:, r * (h + padding):r * (h + padding) + h,
             cidx * (w + padding):cidx * (w + padding) + w] = v
    return grid


def save_video(path: str, video, fps: int = 24,
               value_range=(-1.0, 1.0), retries: int = 3):
    """Save [C, F, H, W] float video; mp4 via imageio-ffmpeg when present,
    else .gif fallback (retry loop mirrors the reference ``cache_video``)."""
    frames = (video if (isinstance(video, np.ndarray)
                        and video.dtype == np.uint8)
              else to_uint8_frames(video, value_range))
    import imageio
    last_err = None
    for _ in range(retries):
        try:
            if path.endswith(".mp4"):
                try:
                    with imageio.get_writer(path, fps=fps,
                                            codec="libx264") as w:
                        for fr in frames:
                            w.append_data(fr)
                    return path
                except Exception:
                    path = os.path.splitext(path)[0] + ".gif"
            imageio.mimsave(path, list(frames),
                            duration=1000.0 / fps, loop=0)
            return path
        except Exception as e:  # pragma: no cover - io flake retry
            last_err = e
    raise RuntimeError(f"failed to save video to {path}: {last_err}")


def save_image(path: str, image, value_range=(-1.0, 1.0)):
    """Save [C, H, W] (or [H, W, C]) float image as png/jpg."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    lo, hi = value_range
    img = np.clip((img - lo) / (hi - lo), 0.0, 1.0)
    import imageio
    imageio.imwrite(path, (img * 255 + 0.5).astype(np.uint8))
    return path

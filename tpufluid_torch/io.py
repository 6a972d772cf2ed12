"""Frame export: the reference's captureScreenshot pipeline without the
browser, counterpart of ``tpufluid.io``.

``frame_to_uint8`` is normalizeTexture: clamp to [0, 1], scale by 255,
truncate to uint8, flip vertically (array row 0 is v = 0, the bottom; PNGs
are top-down). It takes a numpy array or a tensor on any device. PNG and GIF
writing use Pillow, imported inside each function.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch


def _numpy(frame) -> np.ndarray:
    if isinstance(frame, torch.Tensor):
        return frame.detach().cpu().numpy()
    return np.asarray(frame)


def frame_to_uint8(frame_rgba) -> np.ndarray:
    """(4, H, W) or (3, H, W) float -> (H, W, C) uint8, vertically flipped.

    Frames already quantized to (H, W, C) uint8 (the servers' wire frames,
    composited grids of per-sim frames) pass through untouched, with no
    second flip or clamp."""
    arr = _numpy(frame_rgba)
    if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[-1] in (3, 4):
        return arr
    arr = np.clip(arr.astype(np.float32), 0.0, 1.0) * 255.0
    arr = np.moveaxis(arr.astype(np.uint8), 0, -1)   # (H, W, C)
    return arr[::-1]   # row 0 becomes the top


def save_png(frame_rgba, path: str) -> None:
    """Write a frame as PNG (the reference downloads 'fluid.png')."""
    from PIL import Image

    arr = frame_to_uint8(frame_rgba)
    mode = "RGBA" if arr.shape[-1] == 4 else "RGB"
    Image.fromarray(np.ascontiguousarray(arr), mode=mode).save(path)


def load_png(path: str) -> np.ndarray:
    """Read a PNG back to (C, H, W) float32 in [0, 1], bottom-up rows."""
    from PIL import Image

    arr = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    arr = arr[::-1]
    return np.moveaxis(arr, -1, 0).copy()


def save_video_frames(frames: Iterable, out_dir: str, prefix: str = "frame") -> int:
    """Write a frame sequence as numbered PNGs (ffmpeg-ready); returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i, f in enumerate(frames):
        save_png(f, os.path.join(out_dir, f"{prefix}_{i:06d}.png"))
        n += 1
    return n


def save_gif(frames: Iterable, path: str, fps: float = 60.0) -> int:
    """Animated GIF of the frames' RGB (a frame every 1000 / fps ms, at
    least 10); returns the number of frames written."""
    from PIL import Image

    imgs = [Image.fromarray(np.ascontiguousarray(frame_to_uint8(f)[..., :3]), mode="RGB")
            for f in frames]
    if not imgs:
        return 0
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000.0 / fps), 10), loop=0)
    return len(imgs)


def load_dither(path: str) -> np.ndarray:
    """A dither texture PNG -> (H, W) float32 in [0, 1].

    The reference's display shader samples only the red channel of its
    8-bit blue-noise asset, so any PNG reduces to its R channel / 255. Rows
    keep the PNG's order."""
    from PIL import Image

    arr = np.asarray(Image.open(path), dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr / 255.0

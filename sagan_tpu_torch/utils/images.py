"""Sample-image grid utilities (own copy of ``sagan_tpu/utils/images.py``)."""

from __future__ import annotations

import os

import numpy as np


def denormalize(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 as ``uint8(x*127.5 + 127.5)``, clipped."""
    x = np.asarray(x, dtype=np.float32)
    return np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, pad: int = 2) -> np.ndarray:
    """[N, H, W, 3] float in [-1,1] (or uint8) -> one uint8 grid image,
    ceil(sqrt(N)) per side, filled column-major (sample i at row i%n,
    col i//n)."""
    n, h, w, c = images.shape
    side = int(np.ceil(np.sqrt(n)))
    grid = np.zeros((side * (h + pad) - pad, side * (w + pad) - pad, c),
                    np.uint8)
    # uint8 input is already de-normalized (the device-side serving path)
    u8 = images if images.dtype == np.uint8 else denormalize(images)
    for i in range(n):
        col, r = divmod(i, side)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = u8[i]
    return grid


def save_image_grid(images: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(make_grid(images)).save(path)

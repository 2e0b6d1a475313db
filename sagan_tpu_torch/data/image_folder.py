"""Augmenting image-folder loader (``use_image_generator``), the port's own
copy of ``sagan_tpu/data/image_folder.py``: class
subfolders in sorted order (a flat folder is one class), images decoded
with PIL and resized (nearest) to ``img_size``, each drawn through random
horizontal flips, shifts of up to ±0.3 of the side with nearest-edge fill
and a brightness factor in [0.7, 1.3], from the epoch's numpy generator,
so the same folder and seed give the JAX loader's batches.  Process p of
``process_count`` takes ``files[p::count]``; every process takes the
global count's ``steps_per_epoch``, so they stay in lockstep.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np

from .loader import PREFETCH_DEPTH, _lockstep, _prefetch

EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def _scan(root: str):
    """([(path, label)], class count): immediate subfolders are classes
    in sorted order; a flat folder of images is one class."""
    subdirs = sorted(d for d in glob.glob(os.path.join(root, "*"))
                     if os.path.isdir(d))
    files: list[tuple[str, int]] = []
    if subdirs:
        for label, d in enumerate(subdirs):
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(EXTS):
                    files.append((os.path.join(d, f), label))
        num_classes = len(subdirs)
    else:
        for f in sorted(os.listdir(root)):
            if f.lower().endswith(EXTS):
                files.append((os.path.join(root, f), 0))
        num_classes = 1
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files, num_classes


def _augment(img: np.ndarray, rng: np.random.Generator,
             shift: float, brightness: tuple, hflip: bool) -> np.ndarray:
    h, w, _ = img.shape
    if hflip and rng.random() < 0.5:
        img = img[:, ::-1]
    if shift:
        dy = int(rng.uniform(-shift, shift) * h)
        dx = int(rng.uniform(-shift, shift) * w)
        if dy or dx:
            shifted = np.empty_like(img)
            ys, yd = (dy, 0) if dy >= 0 else (0, -dy)
            xs, xd = (dx, 0) if dx >= 0 else (0, -dx)
            shifted[ys:h - yd, xs:w - xd] = img[yd:h - ys, xd:w - xs]
            # nearest-edge fill
            if ys:
                shifted[:ys] = shifted[ys:ys + 1]
            if yd:
                shifted[h - yd:] = shifted[h - yd - 1:h - yd]
            if xs:
                shifted[:, :xs] = shifted[:, xs:xs + 1]
            if xd:
                shifted[:, w - xd:] = shifted[:, w - xd - 1:w - xd]
            img = shifted
    if brightness is not None:
        img = np.clip(img.astype(np.float32) * rng.uniform(*brightness),
                      0, 255).astype(np.uint8)
    return img


class ImageFolderDataset:
    """``ImageDataset``'s interface: ``epoch(i)`` -> (uint8 [B,S,S,3],
    int32 [B]) batches, ``steps_per_epoch``, ``num_classes``, ``meta``.
    A file that does not decode is skipped with a message."""

    reader = "PIL"

    def __init__(self, data_path: str, batch_size: int, img_size: int,
                 data_size: int = -1, seed: int = 0, shift: float = 0.3,
                 brightness=(0.7, 1.3), hflip: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.files, self.num_classes = _scan(data_path)
        if data_size not in (-1, None):
            self.files = self.files[:data_size]
        total = len(self.files)
        self.files = self.files[process_index::process_count]
        self.process_index = process_index
        self.batch_size = batch_size
        self.img_size = img_size
        self.num_records = len(self.files)
        self.steps_per_epoch = (total // process_count) // batch_size
        self.seed = seed
        self.shift, self.brightness, self.hflip = shift, brightness, hflip
        self.meta = {"img_size": img_size, "num_classes": self.num_classes,
                     "num_records": self.num_records}

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode != "RGB":
                im = im.convert("RGB")
            im = im.resize((self.img_size, self.img_size), Image.NEAREST)
            return np.asarray(im, np.uint8)

    def epoch(self, epoch_index: int = 0) -> Iterator[tuple]:
        def gen(attempt: int):
            rng = np.random.default_rng((self.seed, epoch_index, attempt))
            order = rng.permutation(len(self.files))
            s = self.img_size
            imgs = np.empty((self.batch_size, s, s, 3), np.uint8)
            labels = np.empty((self.batch_size,), np.int32)
            fill = 0
            for idx in order:
                path, label = self.files[idx]
                try:
                    img = self._load(path)
                except OSError as err:   # PIL's UnidentifiedImageError too
                    print(f"skip {path}: {err}")
                    continue
                imgs[fill] = _augment(img, rng, self.shift, self.brightness,
                                      self.hflip)
                labels[fill] = label
                fill += 1
                if fill == self.batch_size:
                    yield imgs.copy(), labels.copy()
                    fill = 0

        return _prefetch(_lockstep(gen, self.steps_per_epoch,
                                   self.process_index), PREFETCH_DEPTH)

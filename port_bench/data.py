"""The training cells' dataset: uint8 records of the configuration's image
size, made from the seed on the device in one draw and written in the
program's TFRecord format, so the trainer's own loader and device-cache
feed serve them.

Each record carries its index in its first four bytes (pixel (0, 0)'s
three channels and pixel (0, 1)'s red, little-endian), so the comparison
can tell which records the feed gave a step, check each byte for byte
against this copy, and hand the reference the same images.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch


def make_records(n: int, img_size: int, num_classes: int, seed: int,
                 device) -> tuple:
    """(uint8 images [n, S, S, 3], int32 labels [n]) as numpy arrays."""
    rng = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randint(0, 256, (n, img_size, img_size, 3),
                         dtype=torch.uint8, generator=rng, device=device)
    labels = torch.randint(0, max(1, num_classes), (n,), generator=rng,
                           device=device, dtype=torch.int32)
    idx = torch.arange(n, device=device, dtype=torch.int64)
    marks = torch.stack([(idx >> (8 * i)) & 0xFF for i in range(4)], 1)
    imgs[:, 0, 0, :] = marks[:, :3].to(torch.uint8)
    imgs[:, 0, 1, 0] = marks[:, 3].to(torch.uint8)
    return imgs.cpu().numpy(), labels.cpu().numpy()


def write_records(directory: Path, imgs, labels, num_classes: int) -> None:
    from sagan_tpu_torch.data.tfrecord import write_image_dataset

    shutil.rmtree(directory, ignore_errors=True)
    write_image_dataset(str(directory), imgs, labels.tolist(),
                        imgs.shape[1], max(1, num_classes))


def record_indices(batch_u8: np.ndarray) -> np.ndarray:
    """The record index each image [.., S, S, 3] carries."""
    b = batch_u8.astype(np.int64)
    return (b[..., 0, 0, 0] | (b[..., 0, 0, 1] << 8) | (b[..., 0, 0, 2] << 16)
            | (b[..., 0, 1, 0] << 24))

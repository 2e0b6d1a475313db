"""Synthetic image datasets for tests and smoke runs, the port's own copy
of ``sagan_tpu/data/synthetic.py``: class-structured random images
(per-class hue and blob position) written in the TFRecord dataset
format, so the loader and the trainer run without an external dataset.

    python -m sagan_tpu_torch.data.synthetic data/synthetic_64 \
        --num 2048 --img_size 64
"""

from __future__ import annotations

import numpy as np

from .tfrecord import write_image_dataset


def synthetic_images(num: int, img_size: int, num_classes: int, seed: int = 0):
    """Yield (uint8 image, label) pairs with class-dependent structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    for i in range(num):
        label = int(rng.integers(num_classes))
        hue = (label + 1) / (num_classes + 1)
        cx, cy = rng.uniform(0.25, 0.75, 2)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        blob = np.exp(-r2 / 0.02)
        base = np.stack([
            hue * blob,
            (1 - hue) * blob,
            0.5 * blob,
        ], axis=-1)
        noise = rng.uniform(0, 0.15, base.shape).astype(np.float32)
        img = np.clip((base + noise) * 255.0, 0, 255).astype(np.uint8)
        yield img, label


def make_synthetic_dataset(directory: str, num: int = 256, img_size: int = 32,
                           num_classes: int = 4, seed: int = 0,
                           num_shards: int = 1) -> str:
    pairs = list(synthetic_images(num, img_size, num_classes, seed))
    write_image_dataset(directory, (p[0] for p in pairs),
                        (p[1] for p in pairs), img_size, num_classes,
                        num_shards=num_shards)
    return directory


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="generate a synthetic dataset")
    ap.add_argument("directory")
    ap.add_argument("--num", type=int, default=2048)
    ap.add_argument("--img_size", type=int, default=32)
    ap.add_argument("--num_classes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_shards", type=int, default=1)
    args = ap.parse_args(argv)
    make_synthetic_dataset(args.directory, args.num, args.img_size,
                           args.num_classes, args.seed, args.num_shards)
    print(f"wrote {args.num} records to {args.directory}")


if __name__ == "__main__":
    main()

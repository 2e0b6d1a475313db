"""TFDS -> the TFRecord dataset contract, the port's own copy of
``sagan_tpu/data/tfds_source.py``: convert a ``tensorflow_datasets``
split once into raw-uint8 TFRecords and ``metadata.pickle`` (through the
port's ``data/tfrecord.py``), so training reads it like any other
dataset.  Images not at ``img_size`` are LANCZOS-resized; the class count
is the ``label`` feature's (1 without one).

Needs the ``tensorflow_datasets`` package, imported at call time.

    python -m sagan_tpu_torch.data.tfds_source celeb_a out_dir --img_size 64
"""

from __future__ import annotations

import argparse

import numpy as np


def convert_tfds(name: str, out_dir: str, img_size: int,
                 split: str = "train", limit: int = -1) -> int:
    """Convert up to ``limit`` (all when <= 0) examples of ``name``'s
    ``split``; returns the record count."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(
            "the tfds converter needs the 'tensorflow_datasets' package"
        ) from e
    from PIL import Image

    from .tfrecord import write_image_dataset

    ds, info = tfds.load(name, split=split, with_info=True)
    num_classes = (info.features["label"].num_classes
                   if "label" in info.features else 1)

    def items():
        for i, ex in enumerate(tfds.as_numpy(ds)):
            if limit > 0 and i >= limit:
                return
            img = ex["image"]
            if img.shape[:2] != (img_size, img_size):
                img = np.asarray(
                    Image.fromarray(img).resize((img_size, img_size),
                                                Image.LANCZOS))
            yield img.astype(np.uint8), int(ex.get("label", 0))

    pairs = list(items())
    return write_image_dataset(out_dir, (p[0] for p in pairs),
                               (p[1] for p in pairs), img_size, num_classes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("name", help="tfds dataset name, e.g. celeb_a")
    ap.add_argument("out_dir")
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--split", default="train")
    ap.add_argument("--limit", type=int, default=-1)
    args = ap.parse_args(argv)
    n = convert_tfds(args.name, args.out_dir, args.img_size, args.split,
                     args.limit)
    print(f"wrote {n} records to {args.out_dir}")


if __name__ == "__main__":
    main()

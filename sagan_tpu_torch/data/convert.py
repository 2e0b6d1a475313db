"""Offline dataset converter CLI, image directories -> TFRecords: the
port's own copy of ``sagan_tpu/data/convert.py``, writing through the
port's ``data/tfrecord.py``.

* ``imagenet`` layout: ``<path>/train/n*/*``, the first ``n_class``
  class directories in sorted order, labelled 0, 1, ... in that order;
* LSUN-style layout (``--dataset Lsun_*`` or any other name):
  ``<path>/data/*`` and ``<path>/*`` images (``.jpg``, ``.jpeg``,
  ``.png``, ``.webp``, any case), all label 0;
* each image: grayscale or RGBA to RGB, a center crop to the largest
  square, a LANCZOS resize to ``img_size``; an unreadable file is skipped;
* the files in a seeded shuffle (``random.Random(seed)``), written
  round-robin to ``data.tfrecords`` (or ``data-0000i-of-0000N.tfrecords``
  with ``--num_shards`` N) as raw uint8 ``image_raw`` + int64 ``label``,
  with ``metadata.pickle`` ({img_size, num_classes, num_records}).

The records and the metadata are byte for byte the JAX converter's.

    python -m sagan_tpu_torch.data.convert --path /data/imagenet \\
        --dataset imagenet --img_size 128 --n_class 1000
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import random

import numpy as np

from .tfrecord import TFRecordWriter, encode_example

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp"}


def center_crop_resize(img, img_size: int) -> np.ndarray:
    """A PIL image as uint8 [img_size, img_size, 3]: RGB, the largest
    centered square, LANCZOS-resized."""
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    img = img.crop((left, top, left + s, top + s))
    img = img.resize((img_size, img_size), Image.LANCZOS)
    return np.asarray(img, dtype=np.uint8)


def _gather_imagenet(path: str, n_class: int):
    class_dirs = sorted(glob.glob(os.path.join(path, "train", "n*")))
    if n_class > 0:
        class_dirs = class_dirs[:n_class]
    label_map = {os.path.basename(d): i for i, d in enumerate(class_dirs)}
    files = []
    for d in class_dirs:
        label = label_map[os.path.basename(d)]
        for f in glob.glob(os.path.join(d, "*")):
            files.append((f, label))
    return files, len(class_dirs)


def _gather_flat(path: str):
    files = []
    for d in (os.path.join(path, "data"), path):
        for f in glob.glob(os.path.join(d, "*")):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                files.append(f)
    return [(f, 0) for f in sorted(set(files))], 1


def convert(path: str, dataset: str, img_size: int, n_class: int,
            out_dir: str | None = None, seed: int = 0,
            num_shards: int = 1) -> str:
    """Convert the image tree under ``path``; returns the output
    directory (default ``<path>/<dataset>_{labeled|unlabeled}_<size>``)."""
    from PIL import Image

    if dataset == "imagenet":
        files, num_classes = _gather_imagenet(path, n_class)
    else:
        files, num_classes = _gather_flat(path)
    if not files:
        raise FileNotFoundError(f"no images found under {path}")
    random.Random(seed).shuffle(files)

    out_dir = out_dir or os.path.join(
        path, f"{dataset}_{'labeled' if num_classes > 1 else 'unlabeled'}"
        f"_{img_size}")
    os.makedirs(out_dir, exist_ok=True)
    if num_shards <= 1:
        writers = [TFRecordWriter(os.path.join(out_dir, "data.tfrecords"))]
    else:
        writers = [TFRecordWriter(os.path.join(
            out_dir, f"data-{i:05d}-of-{num_shards:05d}.tfrecords"))
            for i in range(num_shards)]
    n = 0
    try:
        for f, label in files:
            try:
                with Image.open(f) as im:
                    img = center_crop_resize(im, img_size)
            except Exception as e:  # an unreadable file is skipped
                print(f"skip {f}: {e}")
                continue
            writers[n % len(writers)].write(
                encode_example({"image_raw": img.tobytes(),
                                "label": [int(label)]}))
            n += 1
            if n % 1000 == 0:
                print(f"{n} records\r", end="", flush=True)
    finally:
        for w in writers:
            w.close()
    with open(os.path.join(out_dir, "metadata.pickle"), "wb") as f:
        pickle.dump({"img_size": img_size, "num_classes": num_classes,
                     "num_records": n}, f)
    print(f"wrote {n} records to {out_dir}")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", required=True)
    ap.add_argument("--dataset", default="imagenet",
                    help="'imagenet' or 'Lsun_<name>'/flat dir")
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--n_class", type=int, default=-1)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--num_shards", type=int, default=1)
    args = ap.parse_args(argv)
    return convert(args.path, args.dataset, args.img_size, args.n_class,
                   args.out_dir, num_shards=args.num_shards)


if __name__ == "__main__":
    main()

"""LSUN LMDB -> image directory, the port's own copy of
``sagan_tpu/data/export_lmdb.py``: walk a read-only LMDB (the LSUN
distribution format), decode each value, resize its short side to
``size`` (LANCZOS) and write ``<key>.jpg`` (quality 95) into a directory
that ``data/convert.py`` or the image-folder loader reads.

Needs the ``lmdb`` package, imported at call time.

    python -m sagan_tpu_torch.data.export_lmdb church_outdoor_train_lmdb \\
        out_dir --size 256
"""

from __future__ import annotations

import argparse
import io
import os


def export_lmdb_images(db_path: str, out_dir: str, size: int = 256,
                       limit: int = -1) -> int:
    """Export up to ``limit`` (all when <= 0) images; returns the count."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "the LMDB exporter needs the 'lmdb' package; install it or "
            "use the converter on an already-exported image directory"
        ) from e
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    env = lmdb.open(db_path, map_size=1099511627776, max_readers=100,
                    readonly=True)
    with env.begin(write=False) as txn:
        for key, val in txn.cursor():
            with Image.open(io.BytesIO(val)) as im:
                if im.mode != "RGB":
                    im = im.convert("RGB")
                w, h = im.size
                scale = size / min(w, h)
                im = im.resize((round(w * scale), round(h * scale)),
                               Image.LANCZOS)
                name = key.decode("ascii", errors="replace")
                im.save(os.path.join(out_dir, f"{name}.jpg"), quality=95)
            n += 1
            if n % 1000 == 0:
                print(f"{n} images\r", end="", flush=True)
            if limit > 0 and n >= limit:
                break
    env.close()
    print(f"exported {n} images to {out_dir}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db_path")
    ap.add_argument("out_dir")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--limit", type=int, default=-1)
    args = ap.parse_args(argv)
    export_lmdb_images(args.db_path, args.out_dir, args.size, args.limit)


if __name__ == "__main__":
    main()

"""The port's dataset tools (``sagan_tpu_torch/data/convert.py``,
``export_lmdb.py``, ``tfds_source.py``) against the JAX package's on the
same inputs:

* the converter's records and ``metadata.pickle``, byte for byte, on
  generated image trees: the ImageNet layout (``n_class`` of the class
  directories, grayscale and RGBA images), the LSUN layout (uppercase
  extensions, images in ``data/`` and at the top, an unreadable file
  skipped) and ``num_shards`` 3; the port's records decode through the
  port's loader;
* ``export_lmdb`` and ``tfds_source`` over the same stub ``lmdb`` and
  ``tensorflow_datasets`` modules put in ``sys.modules``: the same files,
  byte for byte, and the same ``ImportError`` without those packages.
"""

import io
import os
import sys
import types

import numpy as np
import pytest

from sagan_tpu_torch.data import convert as port_convert
from sagan_tpu_torch.data import export_lmdb as port_lmdb
from sagan_tpu_torch.data import tfds_source as port_tfds
from sagan_tpu_torch.data.loader import ImageDataset
from sagan_tpu_torch.data.tfrecord import load_metadata


def _image(rng, size, mode="RGB"):
    from PIL import Image

    w, h = size
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    return img.convert(mode) if mode != "RGB" else img


def _files(directory) -> dict:
    """{name: bytes} of every file in ``directory``."""
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def _imagenet_tree(root):
    rng = np.random.default_rng(0)
    modes = ("RGB", "L", "RGBA")
    for ci, wnid in enumerate(["n01440764", "n01443537", "n01484850"]):
        d = root / "train" / wnid
        d.mkdir(parents=True)
        for i in range(4):
            _image(rng, (40 + 3 * i, 30 + ci), modes[i % 3]).save(
                str(d / f"{wnid}_{i}.JPEG"), format="PNG")


def _lsun_tree(root):
    rng = np.random.default_rng(1)
    d = root / "data"
    d.mkdir(parents=True)
    for i, ext in enumerate((".jpg", ".JPG", ".png", ".PNG", ".jpeg")):
        _image(rng, (25 + i, 50)).save(
            str(d / f"img_{i}{ext}"),
            format="PNG" if "png" in ext.lower() else "JPEG")
    _image(rng, (33, 33)).save(str(root / "top.webp"), format="WEBP")
    (d / "broken.jpg").write_bytes(b"not an image")
    (d / "notes.txt").write_text("skipped: not an image extension")


@pytest.mark.parametrize("layout,args", [
    ("imagenet", ["--dataset", "imagenet", "--img_size", "16",
                  "--n_class", "2"]),
    ("lsun", ["--dataset", "Lsun_church", "--img_size", "16"]),
    ("imagenet", ["--dataset", "imagenet", "--img_size", "8",
                  "--num_shards", "3"]),
])
def test_the_converter_writes_the_jax_converters_bytes(tmp_path, layout,
                                                       args):
    from sagan_tpu.data.convert import main as jax_convert_main

    src = tmp_path / "src"
    (_imagenet_tree if layout == "imagenet" else _lsun_tree)(src)
    port_out = port_convert.main(["--path", str(src), "--out_dir",
                                  str(tmp_path / "port"), *args])
    jax_out = jax_convert_main(["--path", str(src), "--out_dir",
                                str(tmp_path / "jax"), *args])
    port_files, jax_files = _files(port_out), _files(jax_out)
    assert port_files.keys() == jax_files.keys()
    assert "metadata.pickle" in port_files and len(port_files) >= 2
    for name, data in jax_files.items():
        assert port_files[name] == data, name
    meta = load_metadata(port_out)
    shards = 3 if "--num_shards" in args else 1
    assert len(port_files) == shards + 1
    want = (8, 2) if layout == "imagenet" and "--n_class" in args else (
        (12, 3) if layout == "imagenet" else (6, 1))
    assert (meta["num_records"], meta["num_classes"]) == want
    ds = ImageDataset(port_out, batch_size=meta["num_records"],
                      shuffle_buffer=1, num_workers=1)
    imgs, labels = next(iter(ds.epoch(0)))
    size = meta["img_size"]
    assert imgs.shape == (meta["num_records"], size, size, 3)
    assert set(labels.tolist()) == set(range(meta["num_classes"]))


def test_the_default_output_directory_is_jaxs(tmp_path):
    from sagan_tpu.data.convert import convert as jax_convert

    src = tmp_path / "src"
    _lsun_tree(src)
    port_out = port_convert.convert(str(src), "Lsun_church", 8, -1)
    os.rename(port_out, str(tmp_path / "port"))
    assert jax_convert(str(src), "Lsun_church", 8, -1) == port_out
    assert port_out.endswith("Lsun_church_unlabeled_8")
    with pytest.raises(FileNotFoundError, match="no images found"):
        port_convert.convert(str(tmp_path / "empty"), "imagenet", 8, -1)


# -- the gated tools over stub packages ---------------------------------------
def _lmdb_stub(values: dict) -> types.ModuleType:
    """A stand-in ``lmdb`` module serving ``values`` ({key: bytes}) from
    ``lmdb.open(...)``, read-only."""
    class Txn:
        def cursor(self):
            return iter(sorted(values.items()))

    class Begin:
        def __enter__(self):
            return Txn()

        def __exit__(self, *exc):
            return False

    class Env:
        def begin(self, write=False):
            assert not write
            return Begin()

        def close(self):
            pass

    module = types.ModuleType("lmdb")
    module.open = lambda path, **kw: Env()
    return module


def _encoded(img, fmt) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("limit", [-1, 2])
def test_export_lmdb_writes_the_jax_exporters_files(tmp_path, monkeypatch,
                                                    limit):
    from sagan_tpu.data import export_lmdb as jax_lmdb

    rng = np.random.default_rng(2)
    values = {b"a01": _encoded(_image(rng, (60, 40)), "JPEG"),
              b"b02": _encoded(_image(rng, (30, 70), "L"), "PNG"),
              b"c03": _encoded(_image(rng, (50, 50), "RGBA"), "PNG")}
    monkeypatch.setitem(sys.modules, "lmdb", _lmdb_stub(values))
    n_port = port_lmdb.export_lmdb_images("db", str(tmp_path / "port"),
                                          size=24, limit=limit)
    n_jax = jax_lmdb.export_lmdb_images("db", str(tmp_path / "jax"),
                                        size=24, limit=limit)
    assert n_port == n_jax == (3 if limit < 0 else limit)
    port_files, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port_files == jax_files and len(port_files) == n_port


def _tfds_stub(examples: list, num_classes) -> types.ModuleType:
    """A stand-in ``tensorflow_datasets`` whose ``load`` gives
    ``examples`` and an info with a ``label`` feature of
    ``num_classes`` (no label feature when None)."""
    features = {"image": object()}
    if num_classes is not None:
        features["label"] = types.SimpleNamespace(num_classes=num_classes)
    module = types.ModuleType("tensorflow_datasets")
    module.load = lambda name, split, with_info: (
        (name, split), types.SimpleNamespace(features=features))
    module.as_numpy = lambda ds: iter(examples)
    return module


@pytest.mark.parametrize("num_classes,limit", [(5, -1), (None, 2)])
def test_tfds_source_writes_the_jax_converters_records(tmp_path, monkeypatch,
                                                       num_classes, limit):
    from sagan_tpu.data import tfds_source as jax_tfds

    rng = np.random.default_rng(3)
    examples = []
    for i, shape in enumerate(((16, 16, 3), (20, 12, 3), (16, 16, 3))):
        ex = {"image": rng.integers(0, 256, shape, dtype=np.uint8)}
        if num_classes is not None:
            ex["label"] = np.int64(i % num_classes)
        examples.append(ex)
    monkeypatch.setitem(sys.modules, "tensorflow_datasets",
                        _tfds_stub(examples, num_classes))
    n_port = port_tfds.convert_tfds("stub", str(tmp_path / "port"), 16,
                                    limit=limit)
    n_jax = jax_tfds.convert_tfds("stub", str(tmp_path / "jax"), 16,
                                  limit=limit)
    assert n_port == n_jax == (3 if limit < 0 else limit)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    meta = load_metadata(str(tmp_path / "port"))
    assert meta == {"img_size": 16, "num_classes": num_classes or 1,
                    "num_records": n_port}


@pytest.mark.parametrize("package,call", [
    ("lmdb", lambda tools, tmp: tools[0].export_lmdb_images(
        "db", str(tmp / "out"))),
    ("tensorflow_datasets", lambda tools, tmp: tools[1].convert_tfds(
        "celeb_a", str(tmp / "out"), 16)),
])
def test_the_gated_tools_raise_jaxs_import_errors(tmp_path, monkeypatch,
                                                  package, call):
    from sagan_tpu.data import export_lmdb as jax_lmdb
    from sagan_tpu.data import tfds_source as jax_tfds

    monkeypatch.setitem(sys.modules, package, None)   # import raises
    messages = []
    for tools in ((port_lmdb, port_tfds), (jax_lmdb, jax_tfds)):
        with pytest.raises(ImportError) as err:
            call(tools, tmp_path)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and f"'{package}'" in messages[0]
    assert not (tmp_path / "out").exists()

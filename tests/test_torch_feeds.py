"""The port's other feeds against the JAX package's, on the same files and
seeds (exact: uint8 data): the in-RAM cache decision, the streaming
shuffle buffer (``cache_dataset: False``), the native C++ reader and its
crc32c, the augmenting image-folder loader, the device cache's index
batches, and the trainer on the device-resident dataset against the host
feed, bit for bit, across a mid-epoch restart too; JAX's three
``device_cache=True`` errors, word for word; and the decode workers of
``data_workers``: JAX's batches at 1 and 4, a dead worker's error before
the epoch ends, no thread left behind by an epoch closed early."""

import glob
import os
import pickle
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from sagan_tpu.data import native as jax_native
from sagan_tpu.data.image_folder import ImageFolderDataset as JaxFolder
from sagan_tpu.data.loader import ImageDataset as JaxDataset
from sagan_tpu.data.tfrecord import _crc32c_py as jax_crc32c_py
from sagan_tpu.train.trainer import Trainer as JaxTrainer
from sagan_tpu_torch.data import native, tfrecord
from sagan_tpu_torch.data.image_folder import ImageFolderDataset
from sagan_tpu_torch.data.loader import (DECODE_THREAD, ImageDataset,
                                         get_dataset_and_info)
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.train.trainer import Trainer
from sagan_tpu_torch.utils.config import load_config_file, resolve_config

from test_torch_trainer import _config_file


def _declare(d, **meta):
    """Rewrite ``d``'s metadata.pickle with ``meta`` over what it held."""
    path = os.path.join(d, "metadata.pickle")
    with open(path, "rb") as f:
        old = pickle.load(f)
    with open(path, "wb") as f:
        pickle.dump({**old, **meta}, f)


def _assert_same_batches(got, want, n):
    assert len(got) == len(want) == n
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("records,img_size,cached", [
    (1_281_167, 128, False),   # ImageNet at 128 px: 63 GB decoded
    (2048, 64, True),          # 25 MB
])
def test_the_cache_decision_is_the_jax_rule(tmp_path, records, img_size,
                                            cached):
    """Made from metadata.pickle alone: one tiny file that declares the
    dataset's size."""
    d = make_synthetic_dataset(str(tmp_path / "d"), num=1, img_size=8)
    _declare(d, num_records=records, img_size=img_size)
    port = ImageDataset(d, batch_size=64)
    ref = JaxDataset(d, batch_size=64, use_native=False)
    assert port.cache_in_memory is ref.cache_in_memory is cached
    # what the config asks for wins
    assert ImageDataset(d, batch_size=64,
                        cache_in_memory=not cached).cache_in_memory \
        is (not cached)


@pytest.mark.parametrize("num_shards,declared", [
    (1, None),   # two full epochs
    (3, None),   # three files in the workers' rotation
    (3, 90),     # metadata declares 90 records of 70: the stream runs
                 # short and wraps around into a reshuffled second pass
])
def test_streaming_batches_are_the_jax_batches(tmp_path, num_shards,
                                               declared):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=70, img_size=8,
                               num_classes=4, seed=1, num_shards=num_shards)
    if declared:
        _declare(d, num_records=declared)
    port = ImageDataset(d, batch_size=8, shuffle_buffer=16, seed=5,
                        num_workers=2, cache_in_memory=False)
    ref = JaxDataset(d, batch_size=8, shuffle_buffer=16, seed=5,
                     num_workers=2, cache_in_memory=False, use_native=False)
    assert port.reader == "native" and not port.cache_in_memory
    assert port.steps_per_epoch == ref.steps_per_epoch
    for epoch in (0, 1):
        _assert_same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)),
                             port.steps_per_epoch)
    # the buffer shuffles: not the file order, and not the cached order
    first = next(port.epoch(0))[0]
    assert not np.array_equal(first, port.materialized()[0][:8])
    cached = ImageDataset(d, batch_size=8, seed=5, num_workers=2,
                          cache_in_memory=True)
    assert not np.array_equal(first, next(cached.epoch(0))[0])


def test_get_dataset_and_info_passes_the_streaming_keys(tmp_path):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=20, img_size=8)
    ds, _ = get_dataset_and_info({"data_path": d, "batch_size": 4,
                                  "cache_dataset": False,
                                  "shuffle_buffer": 7})
    assert (ds.cache_in_memory, ds.shuffle_buffer) == (False, 7)
    ds, _ = get_dataset_and_info({"data_path": d, "batch_size": 4})
    assert (ds.cache_in_memory, ds.shuffle_buffer) == (True, 30000)


def test_native_crc32c_is_the_jax_and_python_crc():
    payloads = [b"", b"123456789", b"\x00" * 32,
                np.random.default_rng(0).bytes(10_000)]
    for data in payloads:
        want = tfrecord._crc32c_py(data)
        assert native.crc32c(data) == want == jax_crc32c_py(data)
        assert tfrecord.crc32c(data) == want
    assert native.crc32c(b"123456789") == 0xE3069283


def test_native_reader_decodes_what_both_python_readers_do(tmp_path):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=300, img_size=16,
                               num_classes=7, seed=3)
    path = os.path.join(d, "data.tfrecords")
    want = [tfrecord.parse_image_example(r, 16)
            for r in tfrecord.read_records(path, verify=True)]
    chunks = list(native.read_image_examples(path, 16, chunk=128,
                                             verify=True))
    assert [len(c[1]) for c in chunks] == [128, 128, 44]
    imgs = np.concatenate([c[0] for c in chunks])
    labels = np.concatenate([c[1] for c in chunks])
    np.testing.assert_array_equal(imgs, np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(labels, [w[1] for w in want])
    jax_imgs, jax_labels = map(np.concatenate, zip(
        *jax_native.native_read_image_examples(path, 16, verify=True)))
    np.testing.assert_array_equal(imgs, jax_imgs)
    np.testing.assert_array_equal(labels, jax_labels)
    with pytest.raises(IOError, match="size mismatch"):
        list(native.read_image_examples(path, 32))


def test_native_reader_raises_on_a_corrupt_record(tmp_path):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=16, img_size=8)
    path = os.path.join(d, "data.tfrecords")
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF                  # inside the first record's payload
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt data crc"):
        list(native.read_image_examples(path, 8, verify=True))
    assert len(next(native.read_image_examples(path, 8))[1]) == 16
    for cached in (True, False):
        with pytest.raises(IOError, match="corrupt"):
            list(ImageDataset(d, batch_size=4, cache_in_memory=cached,
                              use_native=True).epoch(0))


def test_the_native_reader_is_a_library_of_the_port(monkeypatch, tmp_path):
    """Built from the port's own source into build/native/, keyed by its
    hash; a build that fails raises where the native reader is asked for
    and leaves the Python reader where it is not."""
    path = native.library_path()
    assert path.parent.parts[-2:] == ("build", "native")
    assert native.load()._name == str(path)
    assert "sagan_tpu/" not in native.load()._name
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libsagan_tfrecord-x.so")
    monkeypatch.setenv("CXX", "false")
    d = make_synthetic_dataset(str(tmp_path / "d"), num=8, img_size=8)
    with pytest.raises(OSError, match="native TFRecord reader"):
        ImageDataset(d, batch_size=4, use_native=True)
    assert ImageDataset(d, batch_size=4).reader == "python"


def _png_folder(root, classes, n, seed=0):
    """``n`` random RGB PNGs of mixed sizes in each of ``classes``
    subfolders (none: a flat folder), and one file that is no image."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in classes or [""]:
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i in range(n):
            h, w = rng.integers(6, 20, 2)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, c, f"{i:03d}.png"))
    with open(os.path.join(root, classes[0] if classes else "",
                           "broken.png"), "wb") as f:
        f.write(b"not a png")
    return str(root)


@pytest.mark.parametrize("classes", [["cat", "dog"], []])
def test_image_folder_batches_are_the_jax_batches(tmp_path, classes):
    root = _png_folder(tmp_path / "imgs", classes, 11)
    port = ImageFolderDataset(root, batch_size=4, img_size=8, seed=3)
    ref = JaxFolder(root, batch_size=4, img_size=8, seed=3)
    assert port.meta == ref.meta
    assert port.num_classes == max(1, len(classes))
    assert port.steps_per_epoch == ref.steps_per_epoch
    for epoch in (0, 1):
        _assert_same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)),
                             port.steps_per_epoch)
    ds, cfg = get_dataset_and_info({"data_path": root, "batch_size": 4,
                                    "use_image_generator": True,
                                    "img_size": 8})
    assert isinstance(ds, ImageFolderDataset)
    assert cfg["num_classes"] == port.num_classes


@pytest.mark.parametrize("declared", [None, 90])
def test_epoch_index_batches_are_the_jax_ones(tmp_path, declared):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=70, img_size=8,
                               num_classes=4, seed=1, num_shards=2)
    if declared:
        _declare(d, num_records=declared)
    port = ImageDataset(d, batch_size=8, seed=5, num_workers=2)
    ref = JaxDataset(d, batch_size=8, seed=5, num_workers=2,
                     use_native=False)
    imgs, labels = port.materialized()
    for epoch in (0, 1):
        got = list(port.epoch_index_batches(epoch))
        want = list(ref.epoch_index_batches(epoch))
        assert len(got) == len(want) == port.steps_per_epoch
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        # gathering them gives the cached epoch's batches
        _assert_same_batches([(imgs[i], labels[i]) for i in got],
                             list(port.epoch(epoch)), port.steps_per_epoch)


@pytest.fixture(scope="module")
def data32(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_feeds_ds")
    return make_synthetic_dataset(str(d), num=64, img_size=32,
                                  num_classes=1, seed=1)


def _trainer(tmp_path, data, ckpt, **overrides):
    config = resolve_config(load_config_file(_config_file(
        tmp_path, data, compute_dtype="float32", log_dir=None, img_dir=None,
        ckpt_dir=ckpt, **overrides)))
    return Trainer(config, device="cpu")


def _recorded(trainer, kill_at=None):
    """Wrap ``trainer``'s train step: keep each call's uint8 images and
    losses; SIGTERM at call ``kill_at``."""
    calls = []
    step_fn = trainer.train_step

    def record(state, images, labels):
        if len(calls) + 1 == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        metrics = step_fn(state, images, labels)
        calls.append((images.clone(), labels.clone(),
                      float(metrics["G_loss"]), float(metrics["D_loss"])))
        return metrics

    trainer.train_step = record
    return calls


def _assert_same_calls(got, want):
    assert len(got) == len(want)
    for (gi, gl, gg, gd), (wi, wl, wg, wd) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gl, wl)
        assert (gg, gd) == (wg, wd)


def test_device_cache_trains_as_the_host_feed_bit_for_bit(tmp_path, data32,
                                                          capsys):
    host = _trainer(tmp_path, data32, None, device_cache=False)
    host_calls = _recorded(host)
    host.train()
    assert host._device_data is None
    assert "feed=host/native" in capsys.readouterr().out

    cached = _trainer(tmp_path, data32, None, device_cache=True)
    cached_calls = _recorded(cached)
    cached.train()
    out = capsys.readouterr().out
    assert "device cache: 0 MB uploaded to cpu (64 records)" in out
    assert "feed=device-cache/native" in out
    _assert_same_calls(cached_calls, host_calls)
    # "auto" takes the cache here (64 records of 32 px fit the budget)
    auto = _trainer(tmp_path, data32, None)
    auto._maybe_build_device_cache()
    assert auto._device_data is not None

    # SIGTERM on the 2nd of epoch 1's 4 calls, then a resume: the calls
    # are the host feed's, and so is the state at the end
    ckpt = str(tmp_path / "ckpt")
    first = _trainer(tmp_path, data32, ckpt, device_cache=True)
    calls = _recorded(first, kill_at=6)
    first.train()
    assert first.global_step() == 12
    resumed = _trainer(tmp_path, data32, ckpt, device_cache=True)
    resumed_calls = _recorded(resumed)
    resumed.train()
    calls += resumed_calls
    assert "resuming mid-epoch: skipping 2" in capsys.readouterr().out
    _assert_same_calls(calls, host_calls)
    for part in ("gen", "disc", "ema"):
        want, got = host.checkpoint_payload()[part], \
            resumed.checkpoint_payload()[part]
        assert all(torch.equal(want[k], got[k]) for k in want), part


def _jax_error(config, ds):
    """The message of the JAX trainer's ``_maybe_build_device_cache`` on
    ``ds`` under ``config``."""
    stub = types.SimpleNamespace(config=config, ds_train=ds, mesh=None,
                                 _device_cache_checked=False)
    with pytest.raises(ValueError) as err:
        JaxTrainer._maybe_build_device_cache(stub)
    return str(err.value)


@pytest.mark.parametrize("case", ["image_folder", "uncached", "budget"])
def test_device_cache_true_raises_the_jax_errors(tmp_path, data32, case):
    overrides = {"device_cache": True}
    if case == "image_folder":
        data = _png_folder(tmp_path / "imgs", ["a", "b"], 8)
        overrides.update(use_image_generator=True, img_size=32,
                         batch_size=4, steps_per_call=1)
        ref_ds = JaxFolder(data, batch_size=4, img_size=32)
    elif case == "uncached":
        data = data32
        overrides["cache_dataset"] = False
        ref_ds = JaxDataset(data, batch_size=8, cache_in_memory=False,
                            use_native=False)
    else:
        data = data32
        overrides["device_cache_budget_mb"] = 0
        ref_ds = JaxDataset(data, batch_size=8, use_native=False)
    trainer = _trainer(tmp_path, data, None, **overrides)
    want = _jax_error(dict(trainer.config), ref_ds)
    with pytest.raises(ValueError) as err:
        trainer.train()
    assert str(err.value) == want
    assert trainer.global_step() == 0
    # "auto" declines with no message and trains on the host feed
    auto = _trainer(tmp_path, data, None,
                    **{**overrides, "device_cache": "auto"})
    auto.train(num_epochs=1)
    assert auto._device_data is None
    assert auto.global_step() == auto.steps_per_epoch


def _decode_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith(DECODE_THREAD) and t.is_alive()]


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("use_native", [True, False])
def test_decode_workers_give_the_jax_batches(tmp_path, workers, use_native):
    """Five shards over ``data_workers`` 1 (inline) and 4 (worker 0 reads
    two files): the cached and the streaming epochs equal JAX's."""
    d = make_synthetic_dataset(str(tmp_path / "d"), num=75, img_size=8,
                               num_classes=3, seed=2, num_shards=5)
    for cached in (True, False):
        kw = dict(batch_size=8, shuffle_buffer=16, seed=4,
                  num_workers=workers, cache_in_memory=cached,
                  use_native=use_native)
        port, ref = ImageDataset(d, **kw), JaxDataset(d, **kw)
        _assert_same_batches(list(port.epoch(1)), list(ref.epoch(1)),
                             port.steps_per_epoch)


@pytest.mark.parametrize("use_native", [True, False])
def test_a_corrupt_shard_raises_before_the_epoch_ends(tmp_path, use_native):
    """Shard 1's first record is corrupt: its worker dies at once, and the
    first batch of an 8-batch streaming epoch raises (the consumer reaches
    that worker's end in the rotation's first round)."""
    d = make_synthetic_dataset(str(tmp_path / "d"), num=64, img_size=8,
                               seed=1, num_shards=4)
    path = sorted(glob.glob(os.path.join(d, "*.tfrecords")))[1]
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF                  # inside the first record's payload
    open(path, "wb").write(bytes(raw))
    ds = ImageDataset(d, batch_size=8, shuffle_buffer=8, num_workers=4,
                      cache_in_memory=False, use_native=use_native)
    assert ds.steps_per_epoch == 8
    epoch = ds.epoch(0)
    with pytest.raises(IOError, match="corrupt data crc"):
        next(epoch)
    _wait_for_no_decode_threads()


def _wait_for_no_decode_threads(timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while _decode_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _decode_threads()


@pytest.mark.parametrize("workers", [1, 4])
def test_an_epoch_closed_early_leaves_no_decode_thread(tmp_path, workers):
    """The consumer takes one batch of a streaming epoch and closes it.
    At 4 workers the records are decoded on four threads (each blocked on
    its full queue by then: 3,072 records a worker, about 1,024 held), and
    the prefetch thread closes the stream it was reading, which stops and
    joins them; at 1 they are read inline."""
    d = make_synthetic_dataset(str(tmp_path / "d"), num=12288, img_size=8,
                               seed=1, num_shards=8)
    ds = ImageDataset(d, batch_size=8, shuffle_buffer=8,
                      num_workers=workers, cache_in_memory=False)
    epoch = ds.epoch(0)
    next(epoch)
    assert len(_decode_threads()) == (4 if workers == 4 else 0)
    epoch.close()
    _wait_for_no_decode_threads()

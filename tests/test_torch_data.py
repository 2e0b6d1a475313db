"""The port's data pipeline (``sagan_tpu_torch/data``) against the JAX
package's: the same synthetic files, the same TFRecord bytes, and the
same batches from the same files and seed, including sharded files read
in the JAX loader's round-robin order.  Exact comparisons (uint8 data)."""

import os
import pickle

import numpy as np
import pytest

from sagan_tpu.data.loader import ImageDataset as JaxDataset
from sagan_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from sagan_tpu.data.tfrecord import encode_example as jax_encode
from sagan_tpu.data.tfrecord import masked_crc32c as jax_masked_crc
from sagan_tpu_torch.data import tfrecord
from sagan_tpu_torch.data.loader import ImageDataset, get_dataset_and_info
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset


def test_crc32c_known_vectors_in_pure_python():
    assert tfrecord._crc32c_py(b"\x00" * 32) == 0x8A9136AA
    assert tfrecord._crc32c_py(b"123456789") == 0xE3069283
    payload = bytes(range(256)) * 5
    assert tfrecord.masked_crc32c(payload) == jax_masked_crc(payload)


def test_example_codec_matches_jax_and_round_trips():
    feats = {"image_raw": bytes(range(256)) * 3, "label": [7, -3],
             "score": [0.5, -2.25]}
    data = tfrecord.encode_example(feats)
    assert data == jax_encode(feats)
    assert tfrecord.decode_example(data) == feats


@pytest.mark.parametrize("num_shards", [1, 3])
def test_synthetic_writer_gives_the_jax_files(tmp_path, num_shards):
    a = make_synthetic_dataset(str(tmp_path / "port"), num=24, img_size=8,
                               num_classes=3, seed=2, num_shards=num_shards)
    b = jax_synthetic(str(tmp_path / "jax"), num=24, img_size=8,
                      num_classes=3, seed=2, num_shards=num_shards)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            if name.endswith(".pickle"):
                assert pickle.load(f) == pickle.load(g)
            else:
                assert f.read() == g.read()


@pytest.mark.parametrize("num_shards,data_size", [(1, -1), (3, 50)])
def test_loader_gives_the_jax_batches(tmp_path, num_shards, data_size):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=70, img_size=8,
                               num_classes=4, seed=1, num_shards=num_shards)
    port = ImageDataset(d, batch_size=8, data_size=data_size, seed=5,
                        num_workers=2)
    ref = JaxDataset(d, batch_size=8, data_size=data_size, seed=5,
                     num_workers=2, cache_in_memory=True, use_native=False)
    assert port.steps_per_epoch == ref.steps_per_epoch
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == port.steps_per_epoch
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == np.uint8 and gl.dtype == np.int32
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    # epochs are shuffled differently
    assert not np.array_equal(next(port.epoch(0))[0],
                              next(port.epoch(1))[0])


def test_get_dataset_and_info_merges_metadata(tmp_path):
    d = make_synthetic_dataset(str(tmp_path / "d"), num=20, img_size=8,
                               num_classes=2)
    ds, cfg = get_dataset_and_info({"data_path": d, "batch_size": 4,
                                    "global_batch_size": 4})
    assert (cfg["img_size"], cfg["num_classes"], cfg["num_records"]) == \
        (8, 2, 20)
    assert ds.steps_per_epoch == 5


def test_corrupted_record_raises(tmp_path):
    """A flipped payload byte fails the crc check and raises at the
    consumer of the prefetch thread; ``verify_crc=False`` still reads."""
    d = make_synthetic_dataset(str(tmp_path / "b"), num=16, img_size=8,
                               num_classes=2)
    path = os.path.join(d, "data.tfrecords")
    with open(path, "r+b") as f:
        f.seek(12 + 40)              # inside the first record's payload
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="corrupt"):
        list(ImageDataset(d, batch_size=4).epoch(0))
    assert len(list(ImageDataset(d, batch_size=4,
                                 verify_crc=False).epoch(0))) == 4


def test_truncated_file_raises(tmp_path):
    d = make_synthetic_dataset(str(tmp_path / "t"), num=16, img_size=8)
    path = os.path.join(d, "data.tfrecords")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2 + 7)
    with pytest.raises(IOError, match="truncated"):
        list(ImageDataset(d, batch_size=4).epoch(0))

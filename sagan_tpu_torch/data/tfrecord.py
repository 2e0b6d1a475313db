"""Standalone TFRecord + tf.train.Example codec (no TensorFlow), the
port's own copy of ``sagan_tpu/data/tfrecord.py``: the portable reference
implementation, beside the native C++ reader of ``data/native`` (the bulk
decode path of the loader).

The on-disk contract: files of framed protobuf ``tf.train.Example``
records with features ``image_raw`` (raw uint8 bytes, HWC) and ``label``
(int64), plus a sibling ``metadata.pickle`` holding ``{img_size,
num_classes, num_records}``, so a dataset written for the JAX package
loads here unchanged, and vice versa.

TFRecord framing:
    uint64  length               (little-endian)
    uint32  masked_crc32c(length)
    bytes   data[length]
    uint32  masked_crc32c(data)
with ``masked_crc = rotr15(crc32c(x)) + 0xa282ead8``.  crc32c runs in
the ``google_crc32c`` package when it is installed, else in the native
reader's slice-by-8 code (built at first use), else in pure Python.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Iterable, Iterator

import numpy as np

# --------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# --------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _make_table():
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()


def _crc32c_py(data: bytes) -> int:
    """Table-driven crc32c in pure Python (~a few MB/s)."""
    crc_val = 0xFFFFFFFF
    tab = _TABLE.tolist()
    for b in memoryview(data):
        crc_val = tab[(crc_val ^ b) & 0xFF] ^ (crc_val >> 8)
    return crc_val ^ 0xFFFFFFFF


try:  # the C implementation, when the package is installed
    import google_crc32c as _gcrc

    def crc32c(data: bytes) -> int:
        return _gcrc.value(bytes(data))
except ImportError:
    def crc32c(data: bytes) -> int:
        # the native reader's crc, built on first use: verification must
        # stay cheap enough to be on by default
        from . import native
        try:
            return native.crc32c(data)
        except OSError:
            return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# minimal protobuf wire codec
# --------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


# --------------------------------------------------------------------------
# tf.train.Example encode
# --------------------------------------------------------------------------


def _encode_feature(value) -> bytes:
    """Encode a Feature message from bytes / list[int] / list[float]."""
    inner = bytearray()
    if isinstance(value, (bytes, bytearray, memoryview)):
        bl = bytearray()
        _write_len_delimited(bl, 1, bytes(value))     # BytesList.value
        _write_len_delimited(inner, 1, bytes(bl))     # Feature.bytes_list
    elif all(isinstance(v, (int, np.integer)) for v in value):
        il = bytearray()
        packed = bytearray()
        for v in value:
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
        _write_len_delimited(il, 1, bytes(packed))    # Int64List.value packed
        _write_len_delimited(inner, 3, bytes(il))     # Feature.int64_list
    else:
        fl = bytearray()
        packed = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
        _write_len_delimited(fl, 1, packed)           # FloatList.value packed
        _write_len_delimited(inner, 2, bytes(fl))     # Feature.float_list
    return bytes(inner)


def encode_example(features: dict) -> bytes:
    """features: name -> bytes | list[int] | list[float]."""
    feats = bytearray()
    for name, value in sorted(features.items()):
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode())          # map key
        _write_len_delimited(entry, 2, _encode_feature(value))  # map value
        _write_len_delimited(feats, 1, bytes(entry))            # Features.feature
    example = bytearray()
    _write_len_delimited(example, 1, bytes(feats))              # Example.features
    return bytes(example)


# --------------------------------------------------------------------------
# tf.train.Example decode
# --------------------------------------------------------------------------


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _decode_feature(buf: memoryview):
    for field, _wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            out = []
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:
                    out.append(bytes(v2))
            return out[0] if len(out) == 1 else out
        if field == 3:  # Int64List
            out = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        pos = 0
                        while pos < len(v2):
                            x, pos = _read_varint(v2, pos)
                            out.append(_to_signed64(x))
                    else:
                        out.append(_to_signed64(v2))
            return out
        if field == 2:  # FloatList
            out = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:
                        out.extend(struct.unpack(f"<{len(v2) // 4}f", v2))
                    else:
                        out.append(struct.unpack("<f", v2)[0])
            return out
    return None


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def decode_example(data: bytes) -> dict:
    """Parse a serialized tf.train.Example into {name: value}."""
    out = {}
    buf = memoryview(data)
    for field, _wire, feats in _iter_fields(buf):
        if field != 1:
            continue
        for f2, _w2, entry in _iter_fields(feats):
            if f2 != 1:
                continue
            name, feat = None, None
            for f3, _w3, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode()
                elif f3 == 2:
                    feat = v3
            if name is not None and feat is not None:
                out[name] = _decode_feature(feat)
    return out


# --------------------------------------------------------------------------
# record-level IO
# --------------------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) == 0:
                return                     # clean end-of-file
            if len(header) < 8:
                # a partial header is truncation, not EOF — treating it
                # as EOF silently drops the tail of the dataset
                raise IOError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            hcrc_bytes = f.read(4)
            if len(hcrc_bytes) < 4:
                raise IOError(f"truncated record header crc in {path}")
            (hcrc,) = struct.unpack("<I", hcrc_bytes)
            if verify and masked_crc32c(header) != hcrc:
                raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated record in {path}")
            dcrc_bytes = f.read(4)
            if len(dcrc_bytes) < 4:
                raise IOError(f"truncated record crc in {path}")
            (dcrc,) = struct.unpack("<I", dcrc_bytes)
            if verify and masked_crc32c(data) != dcrc:
                raise IOError(f"corrupt data crc in {path}")
            yield data


# --------------------------------------------------------------------------
# dataset-level contract
# --------------------------------------------------------------------------


def write_image_dataset(directory: str, images: Iterable[np.ndarray],
                        labels: Iterable[int], img_size: int,
                        num_classes: int,
                        filename: str = "data.tfrecords",
                        num_shards: int = 1) -> int:
    """Write images (uint8 HWC) + labels in the dataset format, plus
    metadata.pickle.

    ``num_shards > 1`` splits output into ``data-0000i-of-0000N.tfrecords``
    files (round-robin) so loaders can shard by file across hosts and
    read with parallel workers."""
    os.makedirs(directory, exist_ok=True)
    if num_shards <= 1:
        writers = [TFRecordWriter(os.path.join(directory, filename))]
    else:
        stem = filename.replace(".tfrecords", "")
        writers = [
            TFRecordWriter(os.path.join(
                directory, f"{stem}-{i:05d}-of-{num_shards:05d}.tfrecords"))
            for i in range(num_shards)
        ]
    n = 0
    try:
        for img, label in zip(images, labels):
            img = np.ascontiguousarray(img, dtype=np.uint8)
            if img.shape != (img_size, img_size, 3):
                raise ValueError(f"image of shape {img.shape}, expected "
                                 f"{(img_size, img_size, 3)}")
            writers[n % len(writers)].write(encode_example({
                "image_raw": img.tobytes(),
                "label": [int(label)],
            }))
            n += 1
    finally:
        for w in writers:
            w.close()
    meta = {"img_size": img_size, "num_classes": num_classes,
            "num_records": n}
    with open(os.path.join(directory, "metadata.pickle"), "wb") as f:
        pickle.dump(meta, f)
    return n


def load_metadata(data_path: str) -> dict:
    """The dataset's ``metadata.pickle`` (image size, class count, record
    count)."""
    with open(os.path.join(data_path, "metadata.pickle"), "rb") as f:
        return pickle.load(f, encoding="latin1")


def parse_image_example(record: bytes, img_size: int):
    """One record -> (uint8 [S,S,3] image, int label)."""
    ex = decode_example(record)
    img = np.frombuffer(ex["image_raw"], dtype=np.uint8)
    img = img.reshape(img_size, img_size, 3)
    label = int(ex["label"][0]) if ex.get("label") else 0
    return img, label

"""TensorBoard-format event writer without TensorFlow, the port's own copy
of ``sagan_tpu/utils/tb_writer.py``: events are protobuf ``Event``
messages in TFRecord framing (the port's codec), so standard TensorBoard
reads the output directly.  Scalar, image and histogram summaries.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time

import numpy as np

from ..data.tfrecord import TFRecordWriter, _write_len_delimited, _write_varint


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  summary: bytes | None = None) -> bytes:
    out = bytearray()
    out.append((1 << 3) | 1)                     # wall_time: double
    out += struct.pack("<d", wall_time)
    if step is not None:
        _write_varint(out, (2 << 3) | 0)         # step: int64
        _write_varint(out, step)
    if file_version is not None:
        _write_len_delimited(out, 3, file_version.encode())
    if summary is not None:
        _write_len_delimited(out, 5, summary)
    return bytes(out)


def _encode_scalar_value(tag: str, value: float) -> bytes:
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    v.append((2 << 3) | 5)                       # simple_value: float
    v += struct.pack("<f", float(value))
    return bytes(v)


def _encode_image_value(tag: str, png: bytes, h: int, w: int) -> bytes:
    img = bytearray()
    _write_varint(img, (1 << 3) | 0)
    _write_varint(img, h)
    _write_varint(img, (2 << 3) | 0)
    _write_varint(img, w)
    _write_varint(img, (3 << 3) | 0)
    _write_varint(img, 3)                        # colorspace RGB
    _write_len_delimited(img, 4, png)
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_len_delimited(v, 4, bytes(img))       # Summary.Value.image
    return bytes(v)


def _encode_histogram_value(tag: str, values: np.ndarray,
                            bins: int = 30) -> bytes:
    """Summary.Value with a HistogramProto (field 5): min/max/num/sum/
    sum_squares + packed bucket_limit/bucket arrays."""
    x = np.asarray(values, np.float64).ravel()
    # drop non-finite entries: np.histogram's autodetected range raises
    # on NaN/inf, which would kill the run at the epoch summary exactly
    # when a diverged GAN most needs observing
    x = x[np.isfinite(x)]
    counts, edges = np.histogram(x, bins=bins)
    h = bytearray()
    for fid, val in ((1, x.min() if x.size else 0.0),
                     (2, x.max() if x.size else 0.0),
                     (3, float(x.size)),
                     (4, float(x.sum())),
                     (5, float(np.square(x).sum()))):
        h.append((fid << 3) | 1)                 # double
        h += struct.pack("<d", float(val))
    for fid, arr in ((6, edges[1:]), (7, counts.astype(np.float64))):
        payload = b"".join(struct.pack("<d", float(a)) for a in arr)
        _write_len_delimited(h, fid, payload)    # packed repeated double
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_len_delimited(v, 5, bytes(h))         # Summary.Value.histo
    return bytes(v)


def _wrap_summary(values: list[bytes]) -> bytes:
    s = bytearray()
    for val in values:
        _write_len_delimited(s, 1, val)
    return bytes(s)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 HWC (or HW) → PNG bytes via PIL."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid suffix (as tf.summary does): two writers on one host in
        # the same second (multi-process runs, back-to-back launches)
        # must not open and truncate the same file
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self._w = TFRecordWriter(os.path.join(logdir, fname))
        self._w.write(_encode_event(time.time(),
                                    file_version="brain.Event:2"))
        self.flush()

    def scalars(self, values: dict, step: int) -> None:
        summary = _wrap_summary(
            [_encode_scalar_value(tag, float(v)) for tag, v in values.items()])
        self._w.write(_encode_event(time.time(), step=step, summary=summary))

    def scalar(self, tag: str, value, step: int) -> None:
        self.scalars({tag: value}, step)

    def histogram(self, tag: str, values, step: int) -> None:
        self.histograms({tag: values}, step)

    def histograms(self, values: dict, step: int) -> None:
        """One histogram summary per ``{tag: array}`` entry, in one
        event."""
        summary = _wrap_summary(
            [_encode_histogram_value(tag, np.asarray(v))
             for tag, v in values.items()])
        self._w.write(_encode_event(time.time(), step=step, summary=summary))

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: uint8 [H, W, 3]."""
        png = encode_png(img)
        summary = _wrap_summary(
            [_encode_image_value(tag, png, img.shape[0], img.shape[1])])
        self._w.write(_encode_event(time.time(), step=step, summary=summary))

    def flush(self) -> None:
        self._w._f.flush()

    def close(self) -> None:
        self._w.close()

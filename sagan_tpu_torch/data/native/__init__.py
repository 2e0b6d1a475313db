"""ctypes bindings for the port's native TFRecord reader
(``tfrecord_reader.cc`` beside this file, the port's own copy of the JAX
package's): record framing, crc32c (slice-by-8) and ``tf.train.Example``
parsing in C++, decoded images streamed into numpy buffers.

The library is built at first use with one ``g++ -O3 -fPIC -shared
-std=c++17`` into ``build/native/libsagan_tfrecord-<hash>.so`` at the root
of the checkout, named by a hash of the source and the flags (an edit
rebuilds), under a file lock so that concurrent processes build it once.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tfrecord_reader.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsagan_tfrecord-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """One ``g++`` into ``path``, unless a concurrent process (holding the
    lock file) already built it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
             str(SOURCE)], capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise OSError(f"g++ exited {out.returncode}:\n{out.stderr}")
        os.replace(tmp, path)  # atomic: readers see all or nothing


def load() -> ctypes.CDLL:
    """The loaded reader, built on first call; raises ``OSError`` with the
    compiler's output when it does not build (and again on every later
    call, without building again)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise OSError(_build_error)
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as err:
            _build_error = f"native TFRecord reader unavailable: {err}"
            raise OSError(_build_error) from err
        lib.sagan_reader_open.restype = ctypes.c_void_p
        lib.sagan_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.sagan_reader_next.restype = ctypes.c_int64
        lib.sagan_reader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64]
        lib.sagan_reader_close.restype = None
        lib.sagan_reader_close.argtypes = [ctypes.c_void_p]
        lib.sagan_reader_error.restype = ctypes.c_char_p
        lib.sagan_reader_error.argtypes = [ctypes.c_void_p]
        lib.sagan_crc32c.restype = ctypes.c_uint32
        lib.sagan_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the reader builds and loads here."""
    try:
        load()
        return True
    except OSError:
        return False


def crc32c(data: bytes) -> int:
    data = bytes(data)
    return int(load().sagan_crc32c(data, len(data)))


def read_image_examples(path: str, img_size: int, chunk: int = 1024,
                        verify: bool = False
                        ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream (uint8 images [k, S, S, 3], int64 labels [k]) chunks of at
    most ``chunk`` records from a TFRecord file, decoded in C++; a
    malformed, truncated or (with ``verify``) corrupt record raises
    ``IOError``."""
    lib = load()
    img_bytes = img_size * img_size * 3
    handle = lib.sagan_reader_open(path.encode(), int(verify))
    if not handle:
        raise IOError(f"cannot open {path}")
    try:
        while True:
            imgs = np.empty((chunk, img_size, img_size, 3), np.uint8)
            labels = np.empty((chunk,), np.int64)
            n = lib.sagan_reader_next(
                handle, imgs.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.c_void_p), chunk, img_bytes)
            if n < 0:
                raise IOError(
                    f"{path}: {lib.sagan_reader_error(handle).decode()}")
            if n == 0:
                return
            yield imgs[:n], labels[:n]
            if n < chunk:
                return
    finally:
        lib.sagan_reader_close(handle)

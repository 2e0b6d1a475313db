"""Host-side data pipeline, the port's own copy of the cached path of
``sagan_tpu/data/loader.py``: TFRecord files -> decoded in-memory cache ->
per-epoch shuffle -> batches -> a prefetch thread.

* Batches leave the host as **uint8** [B, S, S, 3] (NHWC, as stored);
  the train step normalizes them to [-1, 1] on the device.
* Files are read in the JAX loader's order: with ``num_workers`` W, worker
  w owns ``files[w::W]`` and the stream takes one record from each live
  worker in turn (the JAX loader reads them on W threads and merges in
  that fixed rotation; here one thread walks the same rotation).
* Each epoch is an exact permutation of the cached records drawn from
  ``np.random.default_rng((seed, epoch, pass))``, so the same files and
  seed give the same batches as the JAX loader, and a resume that replays
  an epoch and skips its consumed batches sees the batches it would have.
* ``_lockstep`` makes every epoch exactly ``steps_per_epoch`` batches.

The JAX loader's streaming shuffle buffer (``cache_dataset: False``) and
its multi-host sharding are not ported (ROADMAP.md Queue 1 items 7, 14).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator

import numpy as np

from .tfrecord import load_metadata, parse_image_example, read_records

PREFETCH_DEPTH = 2   # batches the loader thread keeps ready
STREAMING_ITEM = ("cache_dataset: False (the streaming shuffle buffer) is "
                  "not ported; the port caches the decoded dataset in RAM, "
                  "ROADMAP.md Queue 1 item 7")


def _find_files(data_path: str) -> list[str]:
    files = sorted(glob.glob(os.path.join(data_path, "*.tfrecords")))
    if not files:
        raise FileNotFoundError(f"no *.tfrecords under {data_path}")
    return files


class ImageDataset:
    """Epoch-oriented iterator of (uint8 images [B,S,S,3], int32 labels
    [B]) from a decoded in-memory cache of the dataset."""

    def __init__(self, data_path: str, batch_size: int,
                 data_size: int = -1, seed: int = 0, num_workers: int = 4,
                 cache_in_memory: bool | None = None,
                 verify_crc: bool = True):
        if cache_in_memory is False:
            raise NotImplementedError(STREAMING_ITEM)
        self.files = _find_files(data_path)
        self.meta = load_metadata(data_path)
        # bit-rot must raise, not train on garbage
        self.verify_crc = verify_crc
        self.num_workers = max(1, num_workers)
        self.img_size = int(self.meta["img_size"])
        self.num_classes = int(self.meta["num_classes"])
        self.num_records = int(self.meta["num_records"])
        self.batch_size = batch_size
        self.data_size = data_size
        self.seed = seed
        total = self.num_records if data_size in (-1, None) \
            else min(data_size, self.num_records)
        self.steps_per_epoch = total // batch_size
        self._cache = None

    def _items(self) -> Iterator[tuple]:
        """(uint8 [S,S,3] image, int label) in the JAX loader's
        round-robin file order, truncated to ``data_size``."""
        limit = self.data_size if self.data_size not in (-1, None) else None
        workers = min(self.num_workers, len(self.files))
        streams = [self._files_items(self.files[w::workers])
                   for w in range(workers)]
        produced = 0
        while streams:
            for stream in list(streams):
                item = next(stream, None)
                if item is None:
                    streams.remove(stream)
                    continue
                if limit is not None and produced >= limit:
                    return
                yield item
                produced += 1

    def _files_items(self, files: list) -> Iterator[tuple]:
        for path in files:
            for rec in read_records(path, verify=self.verify_crc):
                yield parse_image_example(rec, self.img_size)

    def materialized(self):
        """The whole (truncated) dataset as (uint8 [n,S,S,3], int32 [n])."""
        if self._cache is None:
            imgs, labels = [], []
            for img, label in self._items():
                imgs.append(img)
                labels.append(label)
            self._cache = (np.stack(imgs), np.asarray(labels, np.int32))
        return self._cache

    def epoch(self, epoch_index: int = 0) -> Iterator[tuple]:
        """One pass over the data in whole batches (the remainder is
        dropped), prefetched on a thread."""
        imgs, labels = self.materialized()

        def cached_gen(attempt: int):
            rng = np.random.default_rng((self.seed, epoch_index, attempt))
            order = rng.permutation(len(labels))
            for i in range(len(labels) // self.batch_size):
                idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                yield imgs[idx], labels[idx]

        return _prefetch(_lockstep(cached_gen, self.steps_per_epoch),
                         PREFETCH_DEPTH)


def _put_with_stop(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded-queue put that gives up once the consumer is gone (an early
    break or a preemption), so the producer thread never blocks forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _lockstep(make_gen, n: int) -> Iterator[tuple]:
    """Yield EXACTLY ``n`` batches: truncate a long stream and wrap around
    (re-shuffled, pass index ``attempt``) a short one.  ``make_gen`` takes
    the pass index and derives its RNG from it, so the stream stays a pure
    function of the config."""
    count = 0
    attempt = 0
    while count < n:
        produced = False
        for batch in make_gen(attempt):
            produced = True
            yield batch
            count += 1
            if count == n:
                return
        if not produced:
            raise RuntimeError(f"data stream yielded no full batch "
                               f"(need {n})")
        attempt += 1
        print(f"data: stream ran short at {count}/{n} batches; wrapping "
              f"(pass {attempt})", flush=True)


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a daemon thread, keeping ``depth`` items ready.  An
    exception in ``it`` is raised at the consumer's next pull; an
    abandoned consumer releases the thread through a stop flag."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in it:
                if not _put_with_stop(q, item, stop):
                    return
            _put_with_stop(q, end, stop)
        except BaseException as e:  # re-raised by the consumer below
            _put_with_stop(q, _Error(e), stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        stop.set()


def get_dataset_and_info(config: dict):
    """(dataset, config with the dataset's ``img_size``, ``num_classes``
    and ``num_records`` merged in).  ``use_image_generator`` (the
    augmenting image-folder loader) is not ported and raises."""
    if config.get("use_image_generator"):
        raise NotImplementedError(
            "use_image_generator: the augmenting image-folder loader is not "
            "ported, ROADMAP.md Queue 1 item 7")
    config = dict(config)
    ds = ImageDataset(
        config["data_path"],
        batch_size=config.get("global_batch_size", config["batch_size"]),
        data_size=config.get("data_size", -1),
        seed=config.get("data_seed", 0),
        num_workers=config.get("data_workers", 4),
        cache_in_memory=config.get("cache_dataset"),
        verify_crc=config.get("verify_crc", True),
    )
    config.update(ds.meta)
    return ds, config

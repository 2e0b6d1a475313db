"""Host-side data pipeline, the port's own copy of
``sagan_tpu/data/loader.py``: TFRecord files -> this process's shard ->
decoded
records (the native C++ reader, or the pure-Python codec) -> an in-memory
cache with an exact per-epoch shuffle, or a streaming shuffle buffer ->
batches -> a prefetch thread.

* Batches leave the host as **uint8** [B, S, S, 3] (NHWC, as stored);
  the train step normalizes them to [-1, 1] on the device.
* Files are read as the JAX loader reads them: with ``num_workers`` W,
  worker w reads ``files[w::W]`` and the stream takes one record from
  each live worker in turn, so it is a pure function of (files, W).  With
  the native reader (whose calls release the GIL) and W > 1, each worker
  decodes on a thread of its own into a bounded queue.
* ``cache_in_memory`` (None: on when the decoded data is at most 2 GiB,
  the JAX rule): each epoch is an exact permutation of the cached records
  drawn from ``np.random.default_rng((seed, epoch, pass))``.  Off: the
  records stream through a reservoir buffer of ``shuffle_buffer``
  records reseeded from the same triple.  Either way the same files and
  seed give the JAX loader's batches, and a resume that replays an epoch
  and skips its consumed batches sees the batches it would have.
* Per-process shards, JAX's rule: with at least ``process_count`` files,
  process p reads ``files[p::count]`` (and ``data_size // count``
  records); with fewer, every process walks all files and takes the
  records whose global index is p modulo the count.
* ``_lockstep`` makes every epoch exactly ``steps_per_epoch`` batches,
  ``steps_per_epoch`` coming from the global record count, so every
  process takes the same number of steps (the collectives stay matched)
  whatever its shard's length.
"""

from __future__ import annotations

import glob
import itertools
import os
import queue
import threading
from typing import Iterator

import numpy as np

from . import native
from .tfrecord import load_metadata, parse_image_example, read_records

PREFETCH_DEPTH = 2   # batches the loader thread keeps ready
SHUFFLE_BUFFER = 30000   # records in the streaming shuffle buffer
CACHE_LIMIT = 2 << 30    # decoded bytes cached in RAM when not told
NATIVE_CHUNK_BYTES = 32 << 20   # decoded bytes per native reader call
DECODE_CHUNK = 256       # records a decode worker hands over at once
DECODE_QUEUE = 2         # chunks each decode worker keeps ready
DECODE_THREAD = "sagan-decode"   # name prefix of the decode workers


def _find_files(data_path: str) -> list[str]:
    files = sorted(glob.glob(os.path.join(data_path, "*.tfrecords")))
    if not files:
        raise FileNotFoundError(f"no *.tfrecords under {data_path}")
    return files


class ImageDataset:
    """Epoch-oriented iterator of (uint8 images [B,S,S,3], int32 labels
    [B]) of process ``process_index``'s shard, B its ``batch_size``.
    ``use_native`` None takes the native reader when it builds; True
    raises when it does not."""

    def __init__(self, data_path: str, batch_size: int,
                 data_size: int = -1, shuffle_buffer: int = SHUFFLE_BUFFER,
                 seed: int = 0, num_workers: int = 4,
                 cache_in_memory: bool | None = None,
                 verify_crc: bool = True, use_native: bool | None = None,
                 process_index: int = 0, process_count: int = 1):
        self.files = _find_files(data_path)
        self.meta = load_metadata(data_path)
        if use_native is None:
            use_native = native.available()
        elif use_native:
            native.load()
        self.reader = "native" if use_native else "python"
        # bit-rot must raise, not train on garbage
        self.verify_crc = verify_crc
        self.num_workers = max(1, num_workers)
        self.img_size = int(self.meta["img_size"])
        self.num_classes = int(self.meta["num_classes"])
        self.num_records = int(self.meta["num_records"])
        self.batch_size = batch_size
        self.data_size = data_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        total = self.num_records if data_size in (-1, None) \
            else min(data_size, self.num_records)
        per_host = total // process_count
        self.steps_per_epoch = per_host // batch_size
        if cache_in_memory is None:
            cache_in_memory = \
                per_host * self.img_size * self.img_size * 3 <= CACHE_LIMIT
        self.cache_in_memory = cache_in_memory
        self._cache = None

    def _items(self) -> Iterator[tuple]:
        """(uint8 [S,S,3] image, int label) of this process's shard, in
        the JAX loader's order: by file (the shard's files in the
        round-robin of the decode workers, ``data_size // count`` records)
        when there are at least ``process_count`` files, else by global
        record index stride over the files read in order (truncated to
        ``data_size`` records in all)."""
        limit = self.data_size if self.data_size not in (-1, None) else None
        pid, count = self.process_index, self.process_count
        if count == 1 or len(self.files) >= count:
            if limit is not None:
                limit //= count
            produced = 0
            for item in self._multi_file_items(self.files[pid::count]):
                if limit is not None and produced >= limit:
                    return
                yield item
                produced += 1
            return
        index = 0
        for path in self.files:
            for chunk in self._file_chunks(path):
                for item in _records(chunk):
                    if limit is not None and index >= limit:
                        return
                    if index % count == pid:
                        yield item
                    index += 1

    def _multi_file_items(self, files: list) -> Iterator[tuple]:
        """``files`` read by up to ``num_workers`` workers, merged by a
        fixed rotation: worker w reads ``files[w::workers]`` in order, and
        the consumer takes one record from each live worker in turn.  With
        the native reader each worker decodes on a thread of its own and
        hands over decoded chunks, which the consumer splits into records
        (a queue operation a record, or a worker's per-record Python, would
        cost the consumer more of the GIL than the decode saves); the
        Python reader's parse holds the GIL, so its workers are walked
        inline (threads halved its rate on the card's host, PERF.md §5).
        A worker's error is raised when the consumer reaches that worker's
        end, not after the others drain (a consumer that stops at
        ``steps_per_epoch`` would never see it); closing the stream early
        stops and joins the threads."""
        workers = min(self.num_workers, len(files))

        def chunks(w: int) -> Iterator[tuple]:
            for path in files[w::workers]:
                yield from self._file_chunks(path)

        if workers <= 1 or self.reader != "native":
            yield from _rotation([chunks(w) for w in range(workers)])
            return

        end = object()
        queues = [queue.Queue(maxsize=DECODE_QUEUE) for _ in range(workers)]
        errors: list = []
        stop = threading.Event()

        def run(w: int):
            try:
                for chunk in chunks(w):
                    if not _put_with_stop(queues[w], chunk, stop):
                        return
            except Exception as e:   # raised by the consumer, in drained()
                errors.append(e)
            finally:
                _put_with_stop(queues[w], end, stop)

        def drained(w: int) -> Iterator[tuple]:
            while (chunk := queues[w].get()) is not end:
                yield chunk
            if errors:
                raise errors[0]

        threads = [threading.Thread(target=run, args=(w,), daemon=True,
                                    name=f"{DECODE_THREAD}-{w}")
                   for w in range(workers)]
        for t in threads:
            t.start()
        try:
            yield from _rotation([drained(w) for w in range(workers)])
        finally:
            stop.set()
            for t in threads:
                t.join()

    def _file_chunks(self, path: str) -> Iterator[tuple]:
        """(uint8 images [k, S, S, 3], int64 labels [k]) of the file
        ``path`` in order, k from 1 to ``DECODE_CHUNK``."""
        if self.reader == "native":
            img_bytes = self.img_size * self.img_size * 3
            chunk = max(1, min(DECODE_CHUNK, NATIVE_CHUNK_BYTES // img_bytes))
            yield from native.read_image_examples(
                path, self.img_size, chunk, verify=self.verify_crc)
        else:
            records = read_records(path, verify=self.verify_crc)
            while parsed := [parse_image_example(rec, self.img_size)
                             for rec in itertools.islice(records,
                                                         DECODE_CHUNK)]:
                imgs, labels = zip(*parsed)
                yield np.stack(imgs), np.asarray(labels, np.int64)

    def _shuffled(self, rng: np.random.Generator) -> Iterator[tuple]:
        """The records through a reservoir of ``shuffle_buffer``: each
        new record swaps with a random one of a full buffer, which leaves;
        the rest leave shuffled at the end."""
        buf: list[tuple] = []
        for item in self._items():
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = int(rng.integers(len(buf)))
            buf[j], item = item, buf[j]
            yield item
        rng.shuffle(buf)  # type: ignore[arg-type]
        yield from buf

    def materialized(self):
        """The whole (truncated) dataset as (uint8 [n,S,S,3], int32 [n]),
        decoded once (the device cache uploads these)."""
        if self._cache is None:
            imgs, labels = [], []
            for img, label in self._items():
                imgs.append(img)
                labels.append(label)
            self._cache = (np.stack(imgs), np.asarray(labels, np.int32))
        return self._cache

    def epoch_index_batches(self, epoch_index: int) -> Iterator[np.ndarray]:
        """Per-batch record indices (int32 [B]) of the cached ``epoch()``:
        the same (seed, epoch, pass) permutation and lockstep wraparound,
        so gathering them from ``materialized()`` gives its batches."""
        n = len(self.materialized()[1])

        def gen(attempt: int):
            rng = np.random.default_rng((self.seed, epoch_index, attempt))
            order = rng.permutation(n)
            for i in range(n // self.batch_size):
                yield order[i * self.batch_size:
                            (i + 1) * self.batch_size].astype(np.int32)

        return _lockstep(gen, self.steps_per_epoch, self.process_index)

    def epoch(self, epoch_index: int = 0) -> Iterator[tuple]:
        """One pass over the data in whole batches (the remainder is
        dropped), prefetched on a thread."""
        if self.cache_in_memory:
            imgs, labels = self.materialized()

            def gen(attempt: int):
                rng = np.random.default_rng((self.seed, epoch_index, attempt))
                order = rng.permutation(len(labels))
                for i in range(len(labels) // self.batch_size):
                    idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                    yield imgs[idx], labels[idx]
        else:
            def gen(attempt: int):
                rng = np.random.default_rng((self.seed, epoch_index, attempt))
                s = self.img_size
                imgs = np.empty((self.batch_size, s, s, 3), np.uint8)
                labels = np.empty((self.batch_size,), np.int32)
                fill = 0
                for img, label in self._shuffled(rng):
                    imgs[fill] = img
                    labels[fill] = label
                    fill += 1
                    if fill == self.batch_size:
                        yield imgs.copy(), labels.copy()
                        fill = 0

        return _prefetch(_lockstep(gen, self.steps_per_epoch,
                                   self.process_index), PREFETCH_DEPTH)


def _rotation(sources: list) -> Iterator[tuple]:
    """Records of the decoded chunks of ``sources``, one from each source
    that has any left in turn."""
    held = [iter(()) for _ in sources]
    live = list(range(len(sources)))
    while live:
        for w in list(live):
            item = next(held[w], None)
            if item is None:
                chunk = next(sources[w], None)
                if chunk is None:
                    live.remove(w)
                    continue
                held[w] = _records(chunk)
                item = next(held[w])
            yield item


def _records(chunk: tuple) -> Iterator[tuple]:
    """(uint8 [S,S,3] image, int label) records of a decoded chunk, each
    image a copy, so that a record held in the shuffle buffer does not
    keep its whole chunk alive."""
    imgs, labels = chunk
    for img, label in zip(imgs, labels.tolist()):
        yield img.copy(), label


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


def _lockstep(make_gen, n: int, host: int = 0) -> Iterator[tuple]:
    """Yield EXACTLY ``n`` batches: truncate a long stream and wrap around
    (re-shuffled, pass index ``attempt``) a short one, so process
    ``host``, whatever its shard's length, takes as many steps as the
    others (a short one would leave them waiting in the gradient
    all-reduce).  ``make_gen`` takes the pass index and derives its RNG
    from it, so the stream stays a pure function of the config."""
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
            raise RuntimeError(f"host {host}: data stream yielded no full "
                               f"batch (need {n})")
        attempt += 1
        print(f"data: host {host} local stream ran short at {count}/{n} "
              f"batches; wrapping (pass {attempt}) to keep the global step "
              f"count in lockstep", flush=True)


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
        finally:
            # an abandoned stream releases what it holds (decode workers)
            close = getattr(it, "close", None)
            if close is not None:
                close()

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
    and ``num_records`` merged in).  ``use_image_generator`` takes the
    augmenting image-folder loader (``data/image_folder.py``), else the
    TFRecord one; either serves process ``process_index``'s shard in
    batches of ``global_batch_size // process_count``, where under model
    parallelism the process is the data index (``data_index`` of
    ``data_count``): model peers read the same shard, batch for batch."""
    config = dict(config)
    process_count = config.get("data_count", config.get("process_count", 1))
    process_index = config.get("data_index", config.get("process_index", 0))
    batch = config.get("global_batch_size",
                       config["batch_size"]) // process_count
    if config.get("use_image_generator"):
        from .image_folder import ImageFolderDataset
        ds = ImageFolderDataset(
            config["data_path"], batch_size=batch,
            img_size=config["img_size"],
            data_size=config.get("data_size", -1),
            seed=config.get("data_seed", 0),
            process_index=process_index, process_count=process_count)
    else:
        ds = ImageDataset(
            config["data_path"], batch_size=batch,
            data_size=config.get("data_size", -1),
            shuffle_buffer=config.get("shuffle_buffer", SHUFFLE_BUFFER),
            seed=config.get("data_seed", 0),
            num_workers=config.get("data_workers", 4),
            cache_in_memory=config.get("cache_dataset"),
            verify_crc=config.get("verify_crc", True),
            process_index=process_index, process_count=process_count,
        )
    config.update(ds.meta)
    return ds, config

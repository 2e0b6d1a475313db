"""Step timing for the training loop, and kernel timing on the card.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read after a step measures its enqueue.  :class:`StepTimer` takes
fetch-to-fetch deltas instead: ``tick(steps)`` is called only where the
loop has just waited for the card (a metrics fetch), with the number of
steps run since the previous tick.  :func:`cuda_time_ms` times calls
between CUDA events, the counterpart of the JAX package's
``timeit_best`` (``sagan_tpu/utils/timing.py``).
"""

from __future__ import annotations

import statistics
import time

import torch


def cuda_time_ms(fn, *args, iters: int = 20, reps: int = 1,
                 warmup: int = 3) -> tuple[float, float]:
    """(median, minimum) over ``reps`` repeats of the mean ms per call of
    ``fn(*args)``, each the device time of ``iters`` chained calls between
    two CUDA events, after ``warmup`` calls.  Back-to-back calls: inputs
    that fit the 50 MB L2 stay warm in it."""
    for _ in range(warmup):
        fn(*args)
    means = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means), min(means)


class StepTimer:
    """Rolling mean of the seconds per step between synchronisation
    points, over the newest ``window`` ticks."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def start(self) -> None:
        """Arm the timer without recording (after warm-up)."""
        self._last = time.perf_counter()

    def tick(self, steps: int = 1) -> None:
        now = time.perf_counter()
        if self._last is not None and steps > 0:
            self._times.append((now - self._last) / steps)
            del self._times[:-self.window]
        self._last = now

    def mean_ms(self) -> float:
        """Mean ms per step over the window; 0.0 before two ticks."""
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)

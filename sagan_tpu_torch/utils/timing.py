"""Step timing for the training loop.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read after a step measures its enqueue.  :class:`StepTimer` takes
fetch-to-fetch deltas instead: ``tick(steps)`` is called only where the
loop has just waited for the card (a metrics fetch), with the number of
steps run since the previous tick.
"""

from __future__ import annotations

import time


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

"""A profiler window over a training loop, the port of
``sagan_tpu/utils/profiling.py`` ``TraceWindow``: calls ``[start, stop)``
traced with ``torch.profiler`` (host activity, and the card's kernels
when the loop runs on one) into a TensorBoard-readable trace under
``logdir`` (``torch.profiler.tensorboard_trace_handler``).
"""

from __future__ import annotations

import torch


class TraceWindow:
    """Trace calls [start, stop) of a loop: call ``step(i)`` with the
    running call index before each call; the trace opens when i reaches
    ``start`` and closes at ``stop``.  ``close()`` (idempotent) closes a
    still-open trace: call it on early exit (preemption).

    PyTorch returns from a CUDA call before the card has run it, so on a
    card the window waits for it (``torch.cuda.synchronize``) before it
    opens and before it closes: the trace then holds the kernels of calls
    [start, stop), not an arbitrary slice of the queue."""

    def __init__(self, logdir: str, start: int = 10, stop: int = 20,
                 device: torch.device | str = "cpu"):
        self.logdir = logdir
        self.start, self.stop = start, stop
        self.device = torch.device(device)
        self._prof = None

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int) -> None:
        if i == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._barrier()   # calls < start are off the trace
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.logdir))
            self._prof.start()
        elif i >= self.stop and self._prof is not None:
            # >= : a loop that skips past stop (a resume) still closes it
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._barrier()   # calls [start, stop) have run
            prof, self._prof = self._prof, None
            prof.stop()

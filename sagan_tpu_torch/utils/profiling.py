"""The program's spans and a profiler window over a training loop.

:func:`span` marks a layer of the program (the feed, the train step and
its phases, the nets, spectral norm, attention) as a ``sagan.<name>``
range in whatever ``torch.profiler`` trace is being taken, on the same
clock as the kernels it launched; with no profiler running it costs one
check of torch's own flag.  The profiler is the recorder: this module
keeps no spans of its own.

:class:`TraceWindow` is the port of ``sagan_tpu/utils/profiling.py``
``TraceWindow``: calls ``[start, stop)`` traced with ``torch.profiler``
(host activity, and the card's kernels when the loop runs on one) into a
TensorBoard-readable trace under ``logdir``
(``torch.profiler.tensorboard_trace_handler``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

# what span() returns while no profiler runs: one shared no-op
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _recorded(name: str, args: tuple):
    # record_function would take a string argument that no trace keeps;
    # this form records ``args`` as the range's inputs, which a profiler
    # with record_shapes=True keeps ("Concrete Inputs")
    handle = torch.autograd._record_function_with_args_enter(name, *args)
    try:
        yield
    finally:
        torch.autograd._record_function_with_args_exit(handle)


def span(name: str, args: int | None = None):
    """A context manager: the range ``sagan.<name>`` (with ``args``, an
    int such as the global step, as its input) in the running
    ``torch.profiler`` trace; the shared no-op when no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _recorded("sagan." + name, () if args is None else (args,))


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
            # record_shapes: a span's args (sagan.step's global step)
            self._prof = torch.profiler.profile(
                activities=activities, record_shapes=True,
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

"""The device's idle time in the traced sub-window, put down to the
program's spans.

The program marks its layers with ``sagan.<name>`` ranges
(``sagan_tpu_torch/utils/profiling.py`` ``span``), which land in the
profiler's trace beside the kernels, on the same clock, and so among
``Trace.host_ops``.  :func:`idle_by_span` takes the window's idle
intervals (the complement of ``Trace.intervals()`` within
``[trace.start, trace.end]``), cuts them at the start and the end of
every such range, and gives each piece to the innermost span open over
it: the latest-started one still open, on any thread, so a backward span
on autograd's thread wins over the main thread's phase.  A piece under no
span goes to ``OUTSIDE`` (the benchmark's own loop, the profiler's
edges).  The pieces partition the traced idle time exactly.

A program without the spans (one older than them) leaves every piece
outside; :func:`wait_ms` then reads nothing.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

PREFIX = "sagan."
OUTSIDE = "outside"

# the spans each reader sums, as the program names them
FEED = ("sagan.feed",)
STEP = ("sagan.train_step", "sagan.step", "sagan.fakes", "sagan.d_fwd_bwd",
        "sagan.d_adam", "sagan.g_fwd_bwd", "sagan.g_adam", "sagan.ema",
        "sagan.metrics")
LAYERS = ("sagan.G", "sagan.D", "sagan.sn", "sagan.attention",
          "sagan.attention.bwd")


def idle_gaps_ns(trace) -> list:
    """[(start, end)] in ns of the window's intervals in which no kernel
    or copy ran."""
    edges = [trace.start] + [x for se in trace.intervals() for x in se] \
        + [trace.end]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_span(trace) -> dict:
    """{span name or ``OUTSIDE``: idle seconds} of ``trace``'s window."""
    spans = sorted((s, s + d, n) for n, s, d in trace.host_ops
                   if n.startswith(PREFIX))
    # (time, 0 for an end / 1 for a start, span index)
    edges = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    open_heap, closed = [], set()   # (-start, -index): latest start first
    out = defaultdict(int)
    j = 0

    def apply(edge):
        _, starts, i = edge
        if starts:
            heapq.heappush(open_heap, (-spans[i][0], -i))
        else:
            closed.add(i)

    def owner():
        while open_heap and -open_heap[0][1] in closed:
            heapq.heappop(open_heap)
        return spans[-open_heap[0][1]][2] if open_heap else OUTSIDE

    for a, b in idle_gaps_ns(trace):
        while j < len(edges) and edges[j][0] <= a:
            apply(edges[j])
            j += 1
        cur = a
        while j < len(edges) and edges[j][0] < b:
            out[owner()] += edges[j][0] - cur
            cur = edges[j][0]
            apply(edges[j])
            j += 1
        out[owner()] += b - cur
    return {name: ns / 1e9 for name, ns in out.items()}


def wait_ms(ctx: dict, names) -> float | None:
    """Ms a traced step of the device's idle time under the spans
    ``names``; None without a trace, or where the trace holds none of
    those spans."""
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or not steps:
        return None
    if not any(n in names for n, _, _ in tr.host_ops):
        return None
    idle = idle_by_span(tr)
    return sum(idle.get(n, 0.0) for n in names) * 1e3 / steps

"""The traced sub-window: ``torch.profiler`` over a few calls of the timed
path, read into kernel intervals, the device's busy time, and the host op
that was running in each of the device's idle gaps.

The kernel name tables are a copy of ``sagan_tpu_torch/tools/profiling.py``
``ATTENTION_KERNELS`` and ``SN_KERNELS``: the port's attention kernels
(K1-K6, either engine) and its grouped spectral norm (K7, forward and
backward).  As there, a trace now and then comes back without some of
its kernel records; a trace that fails its check is taken again, up to
``TRIES`` times, and the number of tries is recorded.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

TRIES = 3
WINDOW_MARK = "port_bench.traced_window"

ATTENTION_KERNELS = (
    ("K1", ("attention_fwd_kernel<", "attention_fwd_mma_kernel<")),
    ("K2", ("attention_bwd_dq_kernel<", "attention_bwd_dkv_kernel<",
            "attention_bwd_stats_mma_kernel<",
            "attention_bwd_grads_mma_kernel<",
            "attention_bwd_dq_sum_kernel(")),
    ("K3", ("attention_flash_fwd_kernel<", "attention_flash_fwd_mma_kernel<")),
    ("K4", ("attention_flash_dq_kernel<", "attention_flash_dq_mma_kernel<",
            "attention_flash_dq_delta_kernel<")),
    ("K5", ("attention_flash_dkv_kernel<", "attention_flash_dkv_mma_kernel<")),
    ("K6", ("attention_flash_dqkv_kernel<", "attention_flash_dqkv_mma_kernel<",
            "attention_flash_delta_kernel<")),
)
SN_KERNELS = (
    ("K7", ("sn_group_finish_kernel(", "sn_group_rows_kernel(",
            "sn_group_colsum_kernel(")),
    ("K7_bwd", ("sn_group_grad_kernel(", "sn_group_dot_kernel(")),
)
PORT_KERNELS = ATTENTION_KERNELS + SN_KERNELS


def _ns(evt, what: str) -> int:
    ns = getattr(evt, f"{what}_ns", None)
    if ns is not None:
        return int(ns())
    return int(getattr(evt, f"{what}_us")() * 1000)


class Trace:
    """One profiled sub-window: ``kernels`` [(name, start_ns, dur_ns)],
    ``host_ops`` [(name, start_ns, dur_ns)], the window's bounds."""

    def __init__(self, prof):
        self.kernels, self.host_ops = [], []
        self.start = self.end = None
        device = []
        for evt in prof.profiler.kineto_results.events():
            name = evt.name()
            start, dur = _ns(evt, "start"), _ns(evt, "duration")
            if evt.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((name, start, dur))
            elif name == WINDOW_MARK:
                self.start, self.end = start, start + dur
            else:
                self.host_ops.append((name, start, dur))
        # the device-side copies of host annotations (this window's mark,
        # the optimizer's step) span kernels counted on their own
        host_names = {n for n, _, _ in self.host_ops} | {WINDOW_MARK}
        self.kernels = [k for k in device if k[0] not in host_names]
        if self.start is None and self.kernels:
            self.start = min(s for _, s, _ in self.kernels)
            self.end = max(s + d for _, s, d in self.kernels)
        self.kernels = [k for k in self.kernels
                        if self.start <= k[1] < self.end]
        self.launches = sum(1 for n, _, _ in self.host_ops
                            if "LaunchKernel" in n)

    def whole(self) -> bool:
        """Every kernel the host launched in the window has its device
        record (a trace that lost records has fewer)."""
        kernels = sum(1 for n, _, _ in self.kernels
                      if not n.startswith(("Memcpy", "Memset")))
        return kernels > 0 and kernels >= self.launches

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9 if self.start is not None else 0.0

    def intervals(self) -> list:
        """The union of the kernels' intervals, clipped to the window."""
        spans = sorted((s, min(s + d, self.end)) for _, s, d in self.kernels)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def by_name(self) -> dict:
        out = defaultdict(float)
        for name, _, dur in self.kernels:
            out[name] += dur / 1e9
        return dict(out)

    def idle_gaps(self) -> dict:
        """{host op: seconds} of the device's idle time, each gap named
        by the innermost host op running at its middle ("no host op"
        where none was recorded, as on another thread)."""
        out = defaultdict(float)
        edges = [self.start] + [x for se in self.intervals() for x in se] \
            + [self.end]
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        for gap_s, gap_e in zip(edges[::2], edges[1::2]):
            if gap_e <= gap_s:
                continue
            mid = (gap_s + gap_e) // 2
            name = "no host op"
            # the latest-started op still running is the innermost
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 400),
                           -1):
                if mid < ops[i][1] + ops[i][2]:
                    name = ops[i][0]
                    break
            out[name] += (gap_e - gap_s) / 1e9
        return dict(out)

    def table_s(self, table) -> dict:
        """{label: seconds} of the kernels of a name table."""
        out = {}
        for label, names in table:
            out[label] = sum(d for n, _, d in self.kernels
                             if any(x in n for x in names)) / 1e9
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def profiled(run, device) -> tuple:
    """(Trace, tries): ``run()`` under the profiler between two
    synchronizations, taken again (up to ``TRIES``) while the trace is
    not whole; None when no try is."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, TRIES + 1):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_MARK):
                run()
                torch.cuda.synchronize(device)
        trace = Trace(prof)
        if trace.whole():
            return trace, attempt
    return None, TRIES

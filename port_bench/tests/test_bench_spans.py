"""``port_bench/spans.py`` on hand-built traces (no profiler): the device's
idle intervals cut at the program's span edges and each piece given to
the innermost open span, the latest started on any thread; idle under no
span goes outside; the three readers and outside add up to the window's
idle time; a reader reads nothing without a trace or without the spans;
and the module loads no JAX."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from port_bench import common, spans, trace

READERS = ("feed_wait_ms.train", "step_wait_ms.train", "layer_wait_ms.train")
MS = 1_000_000   # ns


def _trace(kernels, host_ops, start=0, end=100 * MS):
    """A ``Trace`` of the window [start, end) with these kernels and host
    ops, each (name, start_ns, dur_ns)."""
    tr = trace.Trace.__new__(trace.Trace)
    tr.kernels, tr.host_ops = list(kernels), list(host_ops)
    tr.start, tr.end, tr.launches = start, end, len(kernels)
    return tr


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k


def test_an_idle_interval_straddling_a_span_edge_is_split_there():
    # idle [0, 10) and [30, 100) ms; the feed ends at 40, where the call
    # begins, and the call ends at 80, inside the second
    tr = _trace([("k", 10 * MS, 20 * MS)],
                [("sagan.feed", 0, 40 * MS),
                 ("sagan.train_step", 40 * MS, 40 * MS)])
    _close(spans.idle_by_span(tr), {"sagan.feed": 0.020,
                                    "sagan.train_step": 0.040,
                                    spans.OUTSIDE: 0.020})


def test_the_latest_started_open_span_wins_across_threads():
    # the main thread's g_fwd_bwd holds [0, 100) ms and its sn [10, 20);
    # autograd's thread holds attention.bwd [20, 70), inside which a span
    # that started later, [30, 40), wins again
    tr = _trace([], [("sagan.g_fwd_bwd", 0, 100 * MS),
                     ("sagan.sn", 10 * MS, 10 * MS),
                     ("sagan.attention.bwd", 20 * MS, 50 * MS),
                     ("sagan.D", 30 * MS, 10 * MS),
                     ("aten::mm", 25 * MS, 5 * MS)])
    _close(spans.idle_by_span(tr), {"sagan.g_fwd_bwd": 0.040,
                                    "sagan.sn": 0.010,
                                    "sagan.attention.bwd": 0.040,
                                    "sagan.D": 0.010})


def test_idle_under_no_span_goes_outside():
    tr = _trace([("k", 0, 50 * MS)], [("aten::add", 60 * MS, 10 * MS)])
    _close(spans.idle_by_span(tr), {spans.OUTSIDE: 0.050})


def test_the_readers_and_outside_add_up_to_the_window_idle():
    host = [("sagan.train_step", 5 * MS, 70 * MS),
            ("sagan.step", 6 * MS, 30 * MS),
            ("sagan.fakes", 7 * MS, 8 * MS), ("sagan.G", 8 * MS, 6 * MS),
            ("sagan.sn", 9 * MS, 1 * MS),
            ("sagan.attention.bwd", 20 * MS, 9 * MS),
            ("sagan.metrics", 31 * MS, 4 * MS),
            ("sagan.feed", 80 * MS, 5 * MS),
            ("cudaLaunchKernel", 81 * MS, 1 * MS)]
    kernels = [("k1", 3 * MS, 2 * MS), ("k2", 9 * MS + 500_000, 4 * MS),
               ("Memcpy HtoD", 40 * MS, 3 * MS), ("k3", 82 * MS, 30 * MS)]
    tr = _trace(kernels, host)
    ctx = {"trace": tr, "steps": 4}
    got = {name: common.metric_reader(name)(ctx) for name in READERS}
    outside = spans.idle_by_span(tr)[spans.OUTSIDE] * 1e3 / 4
    idle_ms = (tr.window_s - tr.busy_s()) * 1e3 / 4
    assert all(v > 0 for v in got.values())
    assert sum(got.values()) + outside == pytest.approx(idle_ms, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_a_trace_or_its_spans(name):
    read = common.metric_reader(name)
    assert read({}) is None
    assert read({"trace": None, "steps": 8}) is None
    # a program without the spans: every idle piece is outside
    tr = _trace([("k", 0, 10 * MS)], [("aten::mm", 20 * MS, 5 * MS)])
    assert read({"trace": tr, "steps": 8}) is None


def test_spans_loads_no_jax():
    code = ("import json, sys\nimport port_bench.spans\n"
            "print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "sagan_tpu",
                        "sagan_tpu_torch"}

"""``tools.profiling.kernel_ms_per_call`` takes a trace again when it came
back without some or all of its kernel records, and reports "not
measured" when no trace is whole; the profiler and the card's
synchronisation are stood in for, so this runs on the CPU."""

import types

import pytest
import torch

from sagan_tpu_torch.tools import profiling

CUDA = torch.autograd.DeviceType.CUDA


def _event(key, ms, count, device_type=CUDA):
    return types.SimpleNamespace(key=key, self_device_time_total=ms * 1e3,
                                 count=count, device_type=device_type)


class _Traces:
    """Stands in for ``torch.profiler.profile``: each trace taken returns
    the next list of events."""

    def __init__(self, traces):
        self.traces = list(traces)
        self.taken = 0

    def __call__(self, activities):
        events = self.traces[self.taken]
        self.taken += 1

        class _Trace:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def key_averages(self):
                return events

        return _Trace()


@pytest.fixture
def traces(monkeypatch):
    def install(*lists):
        fake = _Traces(lists)
        monkeypatch.setattr(torch.profiler, "profile", fake)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        return fake
    return install


@pytest.mark.parametrize("lost", [
    [],                                           # every record lost
    [_event("k_a", 2.0, 20), _event("k_b", 1.0, 13)],   # some lost
], ids=["all_lost", "some_lost"])
def test_a_trace_missing_records_is_taken_again(traces, lost):
    whole = [_event("k_a", 2.0, 20), _event("k_b", 1.0, 20),
             _event("Optimizer.step#Adam.step", 9.0, 20),
             _event("sagan.attention.bwd", 9.0, 20)]
    fake = traces(lost, whole)
    calls = []
    ms = profiling.kernel_ms_per_call(lambda: calls.append(1), calls=20,
                                      warmup=3)
    assert fake.taken == 2
    assert len(calls) == 3 + 2 * 20
    assert ms == pytest.approx(3.0 / 20)


def test_no_whole_trace_is_not_measured(traces):
    fake = traces([], [], [_event("k_a", 1.0, 7)])
    assert profiling.kernel_ms_per_call(lambda: None, calls=20) is None
    assert fake.taken == 3


@pytest.mark.parametrize("ms, text", [
    (None, "not measured"), (0.12345, "0.1235 ms"), (0.0, "0.0000 ms"),
])
def test_ms_or_not_measured(ms, text):
    assert profiling.ms_or_not_measured(ms) == text


@pytest.mark.parametrize("a, b, text", [
    (0.1, 0.4, "0.25x"), (None, 0.4, "not measured"),
    (0.1, None, "not measured"), (0.1, 0.0, "not measured"),
    (0.0, 0.4, "not measured"),
])
def test_ratio_or_not_measured(a, b, text):
    assert profiling.ratio_or_not_measured(a, b) == text

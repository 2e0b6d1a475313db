"""The shape of a run's last line: one JSON object with the keys the
benchmark's contract names, the compared numbers last, and each compared
number on standard error beside its limit."""

import json
import time

import torch

from conftest import VANILLA, tiny_cell
from port_bench import common
from port_bench.run import run_cell


def test_last_line(capsys):
    result = run_cell(tiny_cell(VANILLA), 7, 0.5, False,
                      torch.device("cpu"), time.perf_counter())
    common.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, metric in line["metrics"].items():
        assert set(metric) == {"value", "unit"}, name
    assert set(line["metrics"]) == {"train_imgs_per_s", "setup_s"}
    tail = err.strip().splitlines()[-len(line["compared"]):]
    for text, (name, row) in zip(tail, line["compared"].items()):
        assert text == f"compared {name} {row['value']!r} limit " \
                       f"{row['limit']!r}"


def test_benchmark_json_names_every_file():
    bench = common.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert (common.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = common.cell(w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
    for m in bench["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
        common.metric_reader(m["name"])

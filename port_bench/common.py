"""What every cell of the benchmark shares: where it reads and writes, the
cell's files found by name, seeds, the chip's peaks, and the result line.

The cell files are found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the configuration as run), ``traffic/<mix>.json``
(the mix's parameters; its ``kind`` picks the general driver:
``train`` for ``train_cell.py``), ``limits/<workload>.json`` (the
limit of each number the correctness check compares) and
``metrics/<metric>.py`` (the reader of one per-layer metric).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# everything a run writes, at fixed paths inside the checkout
WORK = ROOT / "build" / "port_bench"

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, fp32 FLOP/s
# outside the tensor cores, HBM3 bytes/s
PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}

# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "sagan_tpu")


def cache_env() -> dict:
    """Fixed cache folders inside the checkout for every compiler the
    program may reach, so a second run of a cell builds nothing."""
    cache = WORK / "cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "CUDA_CACHE_PATH": str(cache / "nv"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def sub_seed(seed: int, *words: int) -> int:
    """A 63-bit seed for purpose ``words`` of run seed ``seed``."""
    state = np.random.SeedSequence([seed, *words]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of workload ``name``: its entry's files loaded, and the
    metrics it reports."""
    bench = benchmark()
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = work[0]
    config = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"workload": work,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def judge(numbers: dict, limits: dict) -> tuple:
    """(all within their limits, {name: {"value", "limit"}}) of the
    numbers ``limits`` names; one that is missing or not finite fails."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def device_info(device, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def read_metrics(cell: dict, ctx: dict) -> dict:
    """The cell's per-layer metrics that their readers find something to
    read for (a reader that finds nothing returns None)."""
    out = {}
    for m in cell["per_layer"]:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def print_result(result: dict) -> None:
    """The compared numbers on stderr, one a line, last; the result as
    the last line of stdout."""
    for name, row in result["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr, flush=True)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    for k in ("breakdown", "profiler_tries", "notes"):
        if k in result:
            line[k] = result[k]
    line["compared"] = result["compared"]
    sys.stdout.flush()
    print(json.dumps(line), flush=True)

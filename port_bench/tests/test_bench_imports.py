"""No module of the harness or the reference loads JAX or the JAX
package (top-level names compared whole: ``sagan_tpu_torch`` begins with
``sagan_tpu``), and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

HARNESS = ["port_bench.run", "port_bench.train_cell", "port_bench.control",
           "port_bench.flops", "port_bench.trace", "port_bench.weights",
           "port_bench.data"]
REFERENCE = ["port_bench.reference.nets", "port_bench.reference.attention",
             "port_bench.reference.train", "port_bench.flops"]


def _top_level(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert not names & {"jax", "jaxlib", "flax", "sagan_tpu"}


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch\n"
            "sys.path.insert(0, 'port_bench/tests')\n"
            "from conftest import tiny_cell, VANILLA\n"
            "from port_bench.run import run_cell\n"
            "from port_bench import common\n"
            "run_cell(tiny_cell(VANILLA), 3, 0.2, False, "
            "torch.device('cpu'), time.perf_counter())\n"
            "print(common.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "sagan_tpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "sagan_tpu"}

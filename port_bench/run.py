"""Runs one cell of the benchmark once:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository, on a machine with the
cards the cell asks for.  Prints the compared numbers last on standard
error and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, and the ``compared`` numbers beside their limits.  Exits
non-zero, printing no result, without the cards, or when a module of
JAX or of the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(common.cache_env())
    import torch

    cell = common.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    common.print_result(result)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device`` (the tests pass the CPU)."""
    from . import train_cell

    driver = {"train": train_cell}[cell["traffic"]["kind"]]
    return driver.run(cell, seed, seconds, traced, device, t_start)


if __name__ == "__main__":
    sys.exit(main())

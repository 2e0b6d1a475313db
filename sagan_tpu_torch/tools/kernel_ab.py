"""The shipped bf16 attention kernels of two checkouts of this repository,
held bit for bit and timed in turns on one GPU: the proof that a change to
``csrc/attention_flash_mma.cu`` left the kernels the model runs as they
were, and what each tree's kernels take on the same card.

    python sagan_tpu_torch/tools/kernel_ab.py --base <other checkout>

Runs this file again as a worker for each tree, in the order base, this
tree, this tree, base, each a process of its own with ``PYTHONPATH`` set
to that tree, so that ``sagan_tpu_torch``, its CUDA sources and its
``build/kernels/`` are that tree's (the two trees' libraries are built
first, side by side).  A worker draws the same seeded inputs on the card
and runs the tensor-core K1 and K2 at church64 G's 64 map (B = 64,
N = 4,096, M = 1,024) and K3, K6 and K4 + K5 (the two-kernel backward) at
church512 G's 512 map (B = 4, N = 262,144, M = 65,536), d = 2, c = 8,
through the wrappers of ``sagan_tpu_torch.ops.cuda_attention``; saves
their outputs; and times each with CUDA events.  Then every output of
every run must be ``torch.equal`` to the first run's, and each kernel's
times are printed by tree beside the card's name and power limit.  Exits
1 if an output differs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
SEED = 14
OUT = ROOT / "build" / "kernel_ab"  # the runs' saved outputs
# (B, N, M) of the single-pass and the flash site; d = 2, c = 8
SITES = {"64 map": (64, 4096, 1024), "512 map": (4, 262144, 65536)}
TIMING = {"iters": 10, "reps": 3, "warmup": 2}


def worker(out: Path, build_only: bool) -> None:
    """One tree's run (the tree on ``PYTHONPATH``): outputs and times of
    its shipped kernels, saved to ``out``."""
    import torch

    from sagan_tpu_torch.ops import _build
    from sagan_tpu_torch.ops import cuda_attention as ca
    from sagan_tpu_torch.utils.timing import cuda_time_ms

    if build_only:
        _build.build(ca.build_specs((8,), (ca.MMA_SOURCE,)))
        return
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(b, n, m):
        return [torch.randn(s, device="cuda", generator=gen).to(torch.bfloat16)
                for s in ((b, n, 2), (b, m, 2), (b, m, 8), (b, n, 8))]

    outs, ms = {}, {}
    q, k, v, g = inputs(*SITES["64 map"])
    calls = {"K1": (ca.attention_fused, (q, k, v)),
             "K2": (ca.attention_bwd_fused, (q, k, v, g))}
    for name, (fn, args) in calls.items():
        got = fn(*args)
        for i, x in enumerate(got if isinstance(got, tuple) else (got,)):
            outs[f"{name}.{i}"] = x.cpu()
        ms[name] = cuda_time_ms(fn, *args, **TIMING)[0]
    q, k, v, g = inputs(*SITES["512 map"])
    o, lse = ca.attention_flash_fwd(q, k, v)
    calls = {"K3": (ca.attention_flash_fwd, (q, k, v)),
             "K6": (ca.attention_flash_dqkv, (q, k, v, o, lse, g)),
             "K4+K5": (ca.attention_flash_dq_dkv, (q, k, v, o, lse, g))}
    for name, (fn, args) in calls.items():
        for i, x in enumerate(fn(*args)):
            outs[f"{name}.{i}"] = x.cpu()
        ms[name] = cuda_time_ms(fn, *args, **TIMING)[0]
    torch.save({"outs": outs, "ms": ms, "module": ca.__file__}, out)


def _run(tree: Path, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(tree))
    return subprocess.Popen([sys.executable, str(HERE), "--worker", *args],
                            env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path,
                    help="the other checkout (its root directory)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--file", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.file, args.build_only)
        return 0
    if args.base is None:
        ap.error("--base is required")
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    trees = {"base": args.base.resolve(), "this": ROOT}
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    builds = [_run(tree, "--build-only") for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a tree's kernels did not build")
    print(f"kernel_ab: both trees' attention_flash_mma built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for i, name in enumerate(("base", "this", "this", "base")):
        out = OUT / f"run{i}_{name}.pt"
        if _run(trees[name], "--file", str(out)).wait():
            raise RuntimeError(f"the {name} tree's run {i} failed")
        runs.append((name, torch.load(out)))
    first = runs[0][1]["outs"]
    equal = {key: all(torch.equal(run["outs"][key], ref)
                      for _, run in runs[1:])
             for key, ref in first.items()}
    times = {kernel: {f"{i} {name}": run["ms"][kernel]
                      for i, (name, run) in enumerate(runs)}
             for kernel in runs[0][1]["ms"]}
    print(json.dumps({"card": card, "trees": {k: str(v)
                                              for k, v in trees.items()},
                      "modules": [run["module"] for _, run in runs],
                      "equal": equal, "ms": times}), flush=True)
    print(f"kernel_ab: every output of the four runs equal to the first "
          f"bit for bit: {all(equal.values())} on {card}", flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

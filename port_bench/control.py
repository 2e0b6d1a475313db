"""The readings that the correctness limits are set from, on the card at a
training cell's own size:

    python3 -m port_bench.control --workload <name> --seeds 1 2 ... \
        [--control_seeds 1 2 3]

For each seed: the program's reading of every number ``train_cell.numbers``
works out (the cell's own set-up, then the reference in fp32), printed as
one JSON line.  For each control seed besides: the same numbers of the
control, the reference computed in fp8 (e4m3 operands, e5m2 gradients,
per-tensor scales: the precision below the configs' bf16) put in the
program's place, and of the reference with a planted fault in its place:
every step on half of its batch, its means over the rest
(``half_batch``); D's updates alone so (``d_half_batch``); the
attention's gradient into k and v doubled (``attn_kv_x2``).  A state
left unchanged, or moved twice, reads 1 on the change and needs no run.
The limits in ``limits/<workload>.json`` lie between the largest program
reading and the smallest control or fault reading (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.update(common.cache_env())
    import torch

    device = torch.device(args.device)
    cell = common.cell(args.workload)
    for seed in args.seeds:
        for row in readings(cell, seed, seed in args.control_seeds, device):
            print(json.dumps(row), flush=True)
    bad = common.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


FAULTS = ("half_batch", "d_half_batch", "attn_kv_x2")


def readings(cell: dict, seed: int, control: bool, device) -> list:
    import torch

    from . import train_cell
    from .reference.nets import Precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    run = train_cell.setup(cell, seed, device, common.WORK / "data"
                           / cell["workload"]["name"])
    del run["trainer"], run["feed"]
    _free(device)
    ok, ref = train_cell.reference(run, device)
    rows = [{"seed": seed, "side": "program", "feed_ok": ok,
             **train_cell.numbers(run["prog"], ref, worst=4)}]
    if control:
        sides = [("control_fp8", {"prec": Precision("fp8")})] + [
            (f"fault_{f}", {"fault": f}) for f in FAULTS]
        for side, kw in sides:
            _, other = train_cell.reference(run, device, **kw)
            rows.append({"seed": seed, "side": side,
                         **train_cell.numbers(other, ref, worst=2)})
    for row in rows:
        row["s"] = time.perf_counter() - t0
    return rows


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

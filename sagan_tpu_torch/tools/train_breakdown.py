"""Where a training step's time goes, on one GPU.

    python -m sagan_tpu_torch.tools.train_breakdown [--steps 20] \\
        [--profile_steps 3] [--config example_configs/church64_attn.py] \\
        [--img_size 64] [--num_classes 1] [--batch B] [--pallas_sn]

Runs the port's train step (``train/trainer.py``) on the config at full
width (church64 by default: bf16, batch 64, update_ratio 1; or the resnet
family, ``example_configs/imagenet128_cond.py --img_size 128
--num_classes 1000``) at ``--img_size`` and ``--num_classes`` (the config
files leave them to the dataset), at the config's batch or ``--batch``
(the global batch, on the one card: church512 at 8 takes the two-kernel
flash backward, K4 + K5), with every spectral norm through the
grouped kernel K7 when ``--pallas_sn`` (the config's ``use_pallas_sn``),
from a seeded init on random uint8 images and labels, and reports, after
5 warm-up steps:

* the medians over ``--steps`` steps of each span of the step, between
  CUDA events the step records as each span ends (``TrainStep.mark``):
  the fakes' G forward, D's forward and backward, D's Adam, G's forward
  and backward (through D), G's Adam, the EMA, the metrics; and
  ``step_device_ms``, the first event to the last;
* ``step_ms``: host clock over the ``--steps`` steps to their end on the
  card, per step, and the images per second it gives;
* from one ``torch.profiler`` trace of ``--profile_steps`` steps: the
  summed kernel time and kernel launches per step, the device's busy
  share (summed kernel time per step over ``step_device_ms``; the traced
  wall time is longer, as the profiler slows the host), each of the
  port's kernels' time and launches per step (K1/K2 on the single-pass
  path, K3 and K6 or K4 + K5 on the flash path of a large map, K7 and
  its backward, one launch a grouped call), and the kernels by time.

Prints one line per measurement and, last, one JSON object of all of
them.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..models import get_discriminator, get_generator
from ..train.optim import make_gan_optimizers
from ..train.trainer import TrainState, build_train_step
from ..utils.config import load_config_file, resolve_config
from ..utils.device import resolve_device
from .profiling import (PORT_KERNELS, attention_kernels, card_line,
                        device_kernels)

WARMUP = 5


class _Events:
    """``TrainStep.mark``: a CUDA event at the end of each span."""

    def __init__(self):
        self.events = []

    def __call__(self, span: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((span, event))

    def spans(self) -> dict:
        """{span: ms} summed over the recorded steps' spans (call after a
        synchronize), then cleared."""
        out = {}
        for (_, a), (span, b) in zip(self.events, self.events[1:]):
            if span != "start":
                out[span] = out.get(span, 0.0) + a.elapsed_time(b)
        first, last = self.events[0][1], self.events[-1][1]
        out["step_device_ms"] = first.elapsed_time(last)
        self.events = []
        return out


def build_step(config: dict, device: torch.device):
    """(the train step of ``config`` from a seeded init on ``device``, a
    closure that takes one step of it on one batch of random uint8 images
    and labels).  The train step and the attention studies'
    ``step_segments`` time it."""
    gen = get_generator(config, rng=torch.Generator().manual_seed(0))
    disc = get_discriminator(config, rng=torch.Generator().manual_seed(1))
    gen.to(device)
    disc.to(device)
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        config, gen.parameters(), disc.parameters(), steps_per_epoch=1000)
    ema = ({n: p.detach().clone() for n, p in gen.named_parameters()}
           if config.get("g_ema_decay", 0.0) > 0 else None)
    state = TrainState(gen, disc, opt_g, opt_d, 0, ema)
    step = build_train_step(config, sched_g, sched_d, gen, disc)
    b, s = config["global_batch_size"], config["img_size"]
    rng = torch.Generator(device=device).manual_seed(0)
    images = torch.randint(0, 256, (1, b, s, s, 3), dtype=torch.uint8,
                           device=device, generator=rng)
    labels = torch.randint(0, config.get("num_classes", 1), (1, b),
                           dtype=torch.int32, device=device, generator=rng)

    def run():
        step(state, images, labels)

    return step, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="example_configs/church64_attn.py")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile_steps", type=int, default=3)
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--num_classes", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the config's)")
    ap.add_argument("--pallas_sn", action="store_true",
                    help="every spectral norm through K7 (use_pallas_sn)")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    config = resolve_config(load_config_file(args.config))
    config.update(img_size=args.img_size, num_classes=args.num_classes)
    if args.batch is not None:
        config.update(batch_size=args.batch, global_batch_size=args.batch)
    if args.pallas_sn:
        config["use_pallas_sn"] = True
    step, run = build_step(config, device)
    b, s = config["global_batch_size"], config["img_size"]

    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()

    events = _Events()
    step.mark = events
    per_step = []
    for _ in range(args.steps):
        run()
        torch.cuda.synchronize()
        per_step.append(events.spans())
    step.mark = None
    spans = {k: statistics.median(r[k] for r in per_step)
             for k in per_step[0]}

    t0 = time.perf_counter()
    for _ in range(args.steps):
        run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    ports = attention_kernels(kernels, args.profile_steps, PORT_KERNELS)
    top = sorted(((k, ms) for k, (ms, _) in kernels.items()),
                 key=lambda kv: -kv[1])[:12]
    name = os.path.splitext(os.path.basename(args.config))[0]

    result = {
        "card": card, "config": args.config, "img_size": s, "batch": b,
        "compute_dtype": config.get("compute_dtype"),
        "use_pallas_sn": bool(config.get("use_pallas_sn")),
        "steps": args.steps, "spans_ms": spans, "step_ms": step_ms,
        "imgs_per_s": b / step_ms * 1e3,
        "profiled_wall_ms_per_step": wall / args.profile_steps,
        "kernel_ms_per_step": busy / args.profile_steps,
        "busy_share": busy / args.profile_steps / spans["step_device_ms"],
        "kernel_launches_per_step": launches / args.profile_steps,
        "kernels_per_step": ports,
        "top": [[k[:80], v / args.profile_steps] for k, v in top],
    }
    print(f"{name} train step, {s} px, B={b} "
          f"{config.get('compute_dtype')}, use_pallas_sn "
          f"{result['use_pallas_sn']}, {card}:")
    for k, v in spans.items():
        print(f"  {k:15s} {v:9.3f} ms (median of {args.steps})")
    print(f"  step_ms {step_ms:.3f} (host clock, {args.steps} steps) = "
          f"{result['imgs_per_s']:.1f} imgs/s")
    print(f"  profiled: {result['kernel_ms_per_step']:.3f} ms of kernels "
          f"per step (busy {result['busy_share']:.1%} of step_device_ms; "
          f"profiled wall {result['profiled_wall_ms_per_step']:.3f} ms), "
          f"{result['kernel_launches_per_step']:.0f} kernel launches per "
          f"step")
    for label, row in ports.items():
        print(f"    {label}: {row['ms']:.4f} ms, {row['launches']:g} "
              f"launches per step")
    for name, ms in result["top"]:
        print(f"    {ms:9.4f} ms/step  {name}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

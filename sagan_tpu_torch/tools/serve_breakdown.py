"""Where a served request's time goes, on one GPU.

    python -m sagan_tpu_torch.tools.serve_breakdown [--reps 10] \\
        [--config example_configs/church64_attn.py] [--img_size 64] \\
        [--num_classes 1] [--batch 64] [--ladder 1,8] [--pallas_sn]

Serves the config's generator (church64 by default: full width, the
config's compute dtype, seeded random weights with nonzero attention
``sigma``; or the resnet family, ``example_configs/imagenet128_cond.py
--img_size 128 --num_classes 1000``, one class a request) at
``--img_size`` and ``--num_classes`` (the config files leave them to the
dataset), with every spectral norm through the grouped kernel K7 when
``--pallas_sn``, from ``GeneratorService(batch, ladder)`` behind
``make_server`` and, for each ladder rung n, reports medians over
``--reps`` runs of:

* ``device_ms``: one generator forward through the serve function, between
  two CUDA events (device time including the gaps the host leaves);
* ``forward_ms``: the same forward on the host clock, to the end of its
  device work, on this script's thread, and ``fresh_thread_ms``: the same
  on a new thread for each call, as a forward on each HTTP handler's
  thread would run (PyTorch keeps cuDNN's execution plans per thread,
  which is why the service runs every forward on one inference thread);
* ``sample_ms``: ``GeneratorService.sample(n)`` on the host clock (latents,
  forward, uint8 fetch);
* ``http_ms``: ``GET /sample?n=<n>&format=raw`` on the host clock;
* from one ``torch.profiler`` trace of a forward: the summed kernel time,
  each of the port's kernels' time and launches (K1, or K3 on the flash
  path of a large map; K7, one launch a grouped call), and the kernels
  by time; the device's busy share is the summed kernel time over
  ``device_ms``.

``GET /healthz`` (no model work) gives the HTTP round trip alone.  Prints
one line per measurement and, last, one JSON object of all of them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
import urllib.request

import torch
from torch.profiler import ProfilerActivity, profile

from ..generate import build_serve_fn
from ..models import get_generator
from ..nn.attention import SelfAttention
from ..serve import GeneratorService, make_server
from ..utils.config import load_config_file, resolve_config
from ..utils.device import resolve_device
from .profiling import (PORT_KERNELS, attention_kernels, card_line,
                        device_kernels)


def _get_ms(url: str) -> float:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as r:
        r.read()
    return (time.perf_counter() - t0) * 1e3


def _device_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _fresh_thread_ms(fn) -> float:
    """``_host_ms(fn)`` on a thread started for this one call."""
    box = []
    thread = threading.Thread(target=lambda: box.append(_host_ms(fn)))
    thread.start()
    thread.join()
    if not box:
        raise RuntimeError("the forward on a fresh thread failed")
    return box[0]


def _kernel_times(fn) -> tuple[float, dict]:
    """(wall ms of one ``fn`` call, {kernel name: (device ms, launches)})
    from a profiler trace."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, device_kernels(prof)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--config", default="example_configs/church64_attn.py")
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64,
                    help="largest serving batch")
    ap.add_argument("--ladder", default="1,8",
                    help="smaller batch sizes, comma-separated")
    ap.add_argument("--num_classes", type=int, default=1)
    ap.add_argument("--pallas_sn", action="store_true",
                    help="every spectral norm through K7 (use_pallas_sn)")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    card = card_line()

    config = resolve_config(load_config_file(args.config))
    config.update(img_size=args.img_size, num_classes=args.num_classes)
    if args.pallas_sn:
        config["use_pallas_sn"] = True
    gen = get_generator(config, rng=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in gen.modules():
            if isinstance(mod, SelfAttention):
                mod.sigma.fill_(0.5)
    gen.to(device)
    ladder = tuple(int(s) for s in args.ladder.split(",") if s.strip())
    svc = GeneratorService(gen, z_dim=config["z_dim"],
                           num_classes=args.num_classes,
                           batch=args.batch, ladder=ladder)
    serve = build_serve_fn(gen)
    srv = make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    result = {"card": card, "config": args.config,
              "img_size": args.img_size,
              "compute_dtype": config.get("compute_dtype"),
              "use_pallas_sn": bool(config.get("use_pallas_sn")),
              "rungs": {}}
    cls = args.num_classes - 1   # every request pins one class
    try:
        healthz = [_get_ms(base + "/healthz") for _ in range(args.reps)]
        result["healthz_ms"] = statistics.median(healthz)
        print(f"/healthz median {result['healthz_ms']:.3f} ms ({card})")
        for n in svc.ladder:
            z = torch.randn(n, config["z_dim"], device=device)
            labels = torch.full((n,), cls, dtype=torch.long, device=device)
            dev = [_device_ms(lambda: serve(z, labels))
                   for _ in range(args.reps)]
            forward = [_host_ms(lambda: serve(z, labels))
                       for _ in range(args.reps)]
            fresh = [_fresh_thread_ms(lambda: serve(z, labels))
                     for _ in range(args.reps)]
            host = []
            for rep in range(args.reps):
                t0 = time.perf_counter()
                svc.sample(n, seed=rep, class_id=cls, truncation=0.0)
                host.append((time.perf_counter() - t0) * 1e3)
            http = [_get_ms(f"{base}/sample?n={n}&seed={rep}"
                            f"&class_id={cls}&format=raw")
                    for rep in range(args.reps)]
            wall, kernels = _kernel_times(lambda: serve(z, labels))
            busy = sum(ms for ms, _ in kernels.values())
            ports = attention_kernels(kernels, table=PORT_KERNELS)
            top = sorted(((k, ms) for k, (ms, _) in kernels.items()),
                         key=lambda kv: -kv[1])[:8]
            row = {"device_ms": statistics.median(dev),
                   "forward_ms": statistics.median(forward),
                   "fresh_thread_ms": statistics.median(fresh),
                   "sample_ms": statistics.median(host),
                   "http_ms": statistics.median(http),
                   "profiled_wall_ms": wall, "kernel_ms": busy,
                   "busy_share": busy / statistics.median(dev),
                   "kernels_by_port": ports,
                   "kernels": len(kernels),
                   "top": [[k[:60], v] for k, v in top]}
            result["rungs"][n] = row
            print(f"n={n}: device_ms {row['device_ms']:.3f} forward_ms "
                  f"{row['forward_ms']:.3f} fresh_thread_ms "
                  f"{row['fresh_thread_ms']:.3f} sample_ms "
                  f"{row['sample_ms']:.3f} http_ms {row['http_ms']:.3f}; "
                  f"kernels {busy:.3f} ms (busy {row['busy_share']:.1%} of "
                  f"device_ms); profiled forward wall {wall:.3f} ms "
                  f"({card})")
            for label, row in ports.items():
                print(f"    {label}: {row['ms']:.4f} ms, {row['launches']:g} "
                      f"launches")
            for name, ms in top:
                print(f"    {ms:9.4f} ms  {name[:90]}")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=30)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""Inference server: a training checkpoint or exported generator weights
-> HTTP, on the card.

Port of ``sagan_tpu/serve.py``:

    python -m sagan_tpu_torch.serve --config_path cfg.py [--weights g.npz] \\
        [--port 8000] [--batch 64] [--ladder 1,8] [--host 127.0.0.1] \\
        [--step N] [--device cuda|cpu] [--num_devices M]

Without ``--weights`` it serves the EMA generator of the newest port
checkpoint in the config's ``ckpt_dir``, or the one of step ``--step``
(``generate.restore_generator``).

stdlib HTTP (``http.server.ThreadingHTTPServer``) in front of the
device-side-uint8 serve function (:func:`generate.build_serve_fn`):

* **a batch ladder** (``--batch`` plus ``--ladder``, default 1,8), each
  size run once at startup: a request is served by ladder chunks
  (:meth:`GeneratorService._chunks`), so an n=1 request does not pay for
  the full batch;
* **de-normalization on the device**: the host fetch moves uint8;
* **one inference thread**: one generator forward in flight at a time;
  concurrent HTTP readers queue (the JAX server's inference lock);
* **data-parallel over M cards** (``--num_devices``, JAX's serving over a
  1-D mesh): G replicated on cards 0…M−1, every batch size a multiple of
  M, each chunk's latents split into M equal slices, each run on its
  card's own inference thread, the images gathered in order.

Endpoints:
  GET /healthz                          -> 200 "ok" once the model is hot
  GET /meta                             -> model geometry JSON
  GET /metrics                          -> Prometheus-style counters
  GET /sample?n=16&seed=0&class_id=-1&truncation=0&format=png|npz|raw
      -> image grid PNG (default), an npz of uint8 images, or raw uint8
         bytes (shape in X-Image-Shape)
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .generate import build_serve_fn, draw_latents, load_generator
from .utils.config import load_config_file, resolve_config
from .utils.device import resolve_device

# Per-request output ceiling in raw uint8 bytes (64 MiB).  /sample's n cap
# derives from this and the image size, so one request can never hold the
# inference thread while concatenating multi-GB host buffers.  The bound is
# on the REQUESTED image count: the device computes whole ladder chunks,
# so the host buffer can exceed it by the one finishing chunk's slice.
MAX_SAMPLE_BYTES = 64 << 20


def request_cap(min_batch: int, img_size: int) -> int:
    """Max images one /sample request may ask for: 4096 absolute,
    tightened so raw output stays under MAX_SAMPLE_BYTES, never below one
    smallest ladder batch."""
    return min(4096,
               max(min_batch, MAX_SAMPLE_BYTES // (img_size * img_size * 3)))


class GeneratorService:
    """Owns the serve function, its latent stream and the inference
    thread.

    ``gen`` is the eval-mode generator, already on its device.  ``ladder``
    lists extra smaller batch sizes beside ``batch``; each is run once
    here, so ``/healthz`` reflects a hot model (kernels built and loaded).

    Every forward runs on ONE inference thread, which also serializes
    them (the JAX server's inference lock): PyTorch keeps cuDNN's
    execution plans per thread, so a forward on each HTTP handler's fresh
    thread would plan every convolution anew (~50 ms a request on an
    H100).  ``close()`` stops the threads.

    ``num_devices`` M > 1 serves data-parallel: G is copied to each of
    ``devices`` (default: cards 0…M−1, or M times the CPU for a G there;
    more cards than are visible raises), every batch size rounds up to a
    multiple of M, and device i's slice of a chunk runs on device i's own
    inference thread (device 0's also draws the latents and gathers the
    images in order).  Tests pass ``devices=["cpu", "cpu"]``."""

    def __init__(self, gen, z_dim: int, num_classes: int, batch: int,
                 seed: int = 0, num_devices: int = 1,
                 ladder: tuple = (1, 8), devices=None):
        self.z_dim = z_dim
        self.num_classes = max(1, num_classes)
        self.device = next(gen.parameters()).device
        self._devices = _serving_devices(self.device, num_devices or 1,
                                         devices)
        self.num_devices = len(self._devices)
        self._fn = build_serve_fn(gen)
        self._replica_fns = [build_serve_fn(copy.deepcopy(gen).to(d))
                             for d in self._devices[1:]]
        self._workers = [ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"sagan-inference-{i}")
            for i in range(self.num_devices)]
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self.requests_total = 0
        self.images_total = 0
        self.images_computed_total = 0
        self.sample_seconds_total = 0.0
        # every compiled size splits evenly over the devices
        m = self.num_devices
        batch = -(-batch // m) * m
        sizes = {batch}
        for s in ladder or ():
            s = -(-int(s) // m) * m
            if 0 < s <= batch:
                sizes.add(s)
        self.ladder = sorted(sizes)
        self.batch = batch
        try:
            out = self._workers[0].submit(self._warm_up).result()
        except BaseException:
            self.close(wait=False)
            raise
        self.img_size = int(out.shape[1])
        self.max_request_images = request_cap(self.ladder[0], self.img_size)

    def _warm_up(self) -> np.ndarray:
        for s in self.ladder:
            z = torch.zeros((s, self.z_dim), device=self.device)
            labels = torch.zeros((s,), dtype=torch.long, device=self.device)
            out = self._forward(z, labels)
        return out

    def _forward(self, z, labels) -> np.ndarray:
        """A chunk's uint8 images, on device 0's thread: slice i of the
        latents on device i's thread (slice 0 here), gathered in order."""
        zs, ls = z.chunk(self.num_devices), labels.chunk(self.num_devices)
        others = [worker.submit(_serve_slice, fn, zi, li, d)
                  for worker, fn, zi, li, d in zip(
                      self._workers[1:], self._replica_fns, zs[1:], ls[1:],
                      self._devices[1:])]
        first = self._fn(zs[0], ls[0]).cpu().numpy()
        return np.concatenate([first] + [f.result() for f in others])

    def close(self, wait: bool = True) -> None:
        """Stop the inference threads (after any forward in flight)."""
        for worker in self._workers:
            worker.shutdown(wait=wait)

    def _chunks(self, n: int):
        """Ladder decomposition of ``n``: greedy
        largest-compiled-size-<=-remaining, except the request FINISHES
        with ONE rung >= the remainder when (a) that wastes strictly less
        than the remainder, or (b) greedy would repeat the smallest rung.
          n=1 -> [1]   n=3 -> [8]   n=7 -> [8]   n=9 -> [8, 1]
          n=11 -> [8, 8]   n=63 -> [64]   n=130 -> [64, 64, 8]
        The overshoot (sliced off by the caller) is bounded by the one
        finishing chunk.  A single-rung ladder rounds up to the batch."""
        remaining = n
        while remaining > 0:
            up = min((s for s in self.ladder if s >= remaining),
                     default=None)
            down = max((s for s in self.ladder if s <= remaining),
                       default=None)
            if up is not None and (
                    up < 2 * remaining                     # rule (a)
                    or down is None
                    or (down == self.ladder[0]
                        and remaining > down)):            # rule (b)
                yield up
                return
            if down is None:  # no rung fits either way: smallest, sliced
                yield self.ladder[0]
                return
            yield down
            remaining -= down

    def sample(self, n: int, seed: int | None, class_id: int,
               truncation: float) -> np.ndarray:
        """n uint8 images [n, H, W, 3] from ladder chunks, sliced to n.
        A ``seed`` gives the same images every time; without one the
        server's own latent stream advances."""
        return self._workers[0].submit(self._sample, n, seed, class_id,
                                       truncation).result()

    def _sample(self, n, seed, class_id, truncation) -> np.ndarray:
        out = []
        t0 = time.perf_counter()
        rng = (torch.Generator(device=self.device).manual_seed(seed)
               if seed is not None else self._rng)
        for size in self._chunks(n):
            z, labels = draw_latents(rng, size, self.z_dim, self.num_classes,
                                     truncation, class_id)
            out.append(self._forward(z, labels))
            self.images_computed_total += size
        self.requests_total += 1
        self.images_total += n
        self.sample_seconds_total += time.perf_counter() - t0
        return np.concatenate(out)[:n]

    def metrics_text(self) -> str:
        """Prometheus-style plaintext counters."""
        return (
            "# TYPE sagan_requests_total counter\n"
            f"sagan_requests_total {self.requests_total}\n"
            "# TYPE sagan_images_total counter\n"
            f"sagan_images_total {self.images_total}\n"
            "# TYPE sagan_images_computed_total counter\n"
            f"sagan_images_computed_total {self.images_computed_total}\n"
            "# TYPE sagan_sample_seconds_total counter\n"
            f"sagan_sample_seconds_total {self.sample_seconds_total:.6f}\n"
            "# TYPE sagan_serving_devices gauge\n"
            f"sagan_serving_devices {self.num_devices}\n")


def _serving_devices(home: torch.device, num_devices: int,
                     devices=None) -> list:
    """The devices G serves from: ``devices`` as given (their count must
    be ``num_devices`` when that is above 1), else ``home`` for one, else
    cards 0…M−1 (a G on the CPU: M times the CPU, which counts as one
    device), raising past the visible count as JAX's ``make_mesh``."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if num_devices > 1 and num_devices != len(devices):
            raise ValueError(f"num_devices={num_devices} contradicts the "
                             f"{len(devices)} devices passed")
        if devices[0] != home:
            raise ValueError(f"the first serving device {devices[0]} is not "
                             f"G's, {home}")
        return devices
    if num_devices == 1:
        return [home]
    have = torch.cuda.device_count() if home.type == "cuda" else 1
    if num_devices > have:
        raise ValueError(f"requested {num_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(num_devices)]


def _serve_slice(fn, z, labels, device) -> np.ndarray:
    """``fn`` on ``device``'s copy of (z, labels), fetched as uint8."""
    return fn(z.to(device), labels.to(device)).cpu().numpy()


def _make_handler(svc: GeneratorService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # stderr noise -> off
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  extra: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/healthz":
                    return self._send(200, b"ok", "text/plain")
                if url.path == "/meta":
                    meta = {"img_size": svc.img_size, "z_dim": svc.z_dim,
                            "num_classes": svc.num_classes,
                            "batch": svc.batch,
                            "ladder": svc.ladder,
                            "num_devices": svc.num_devices}
                    return self._send(
                        200, json.dumps(meta).encode(), "application/json")
                if url.path == "/metrics":
                    return self._send(200, svc.metrics_text().encode(),
                                      "text/plain")
                if url.path == "/sample":
                    q = parse_qs(url.query)

                    def one(name, cast, default):
                        return cast(q[name][0]) if name in q else default

                    try:
                        n = max(one("n", int, 16), 1)
                        seed = one("seed", int, None)
                        class_id = one("class_id", int, -1)
                        trunc = one("truncation", float, 0.0)
                    except ValueError as e:
                        # a client error, not a server fault: ?n=abc
                        return self._send(
                            400, f"bad query parameter: {e}".encode(),
                            "text/plain")
                    if n > svc.max_request_images:
                        return self._send(
                            400, f"n={n} exceeds the per-request cap "
                            f"{svc.max_request_images} at "
                            f"{svc.img_size}px".encode(),
                            "text/plain")
                    if class_id >= svc.num_classes:
                        return self._send(
                            400, f"class_id {class_id} out of range "
                            f"(num_classes={svc.num_classes})".encode(),
                            "text/plain")
                    fmt = one("format", str, "png")
                    imgs = svc.sample(n, seed, class_id, trunc)
                    if fmt == "npz":
                        buf = io.BytesIO()
                        np.savez_compressed(buf, images=imgs)
                        return self._send(200, buf.getvalue(),
                                          "application/octet-stream")
                    if fmt == "raw":
                        return self._send(
                            200, imgs.tobytes(), "application/octet-stream",
                            {"X-Image-Shape":
                             "x".join(map(str, imgs.shape)),
                             "X-Image-Dtype": "uint8"})
                    from PIL import Image

                    from .utils.images import make_grid
                    buf = io.BytesIO()
                    Image.fromarray(make_grid(imgs)).save(buf, format="PNG")
                    return self._send(200, buf.getvalue(), "image/png")
                return self._send(404, b"not found", "text/plain")
            except BrokenPipeError:
                pass
            except Exception as e:  # surface, don't kill the thread
                try:
                    self._send(500, f"{type(e).__name__}: {e}".encode(),
                               "text/plain")
                except Exception:
                    pass

    return Handler


def make_server(svc: GeneratorService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound-but-not-serving server (call ``serve_forever``); port 0
    picks a free port (``server_address[1]`` has the real one)."""
    return ThreadingHTTPServer((host, port), _make_handler(svc))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve exported sagan generator weights over HTTP "
                    "from the card")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--weights", default=None,
                    help="exported generator .npz (sagan_tpu.generate "
                         "--export); default: the newest checkpoint in "
                         "the config's ckpt_dir")
    ap.add_argument("--step", type=int, default=None,
                    help="restore this checkpointed step (default latest)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=64,
                    help="largest serving batch")
    ap.add_argument("--ladder", default="1,8",
                    help="extra batch sizes (comma-separated) serving small "
                         "requests without paying the full batch; '' runs "
                         "only --batch")
    ap.add_argument("--num_devices", type=int, default=1,
                    help="cards to serve from, data-parallel (0..M-1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # fp32 convolutions stay fp32, as the JAX layers ask for HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    config = resolve_config(load_config_file(args.config_path))
    try:
        ladder = tuple(int(s) for s in args.ladder.split(",") if s.strip())
    except ValueError:
        raise SystemExit(f"--ladder must be comma-separated ints, got "
                         f"{args.ladder!r}")
    gen = load_generator(config, args.weights, device, args.step)
    svc = GeneratorService(
        gen, z_dim=config["z_dim"], num_classes=config.get("num_classes", 1),
        batch=args.batch, seed=args.seed, ladder=ladder,
        num_devices=args.num_devices)
    srv = make_server(svc, args.host, args.port)
    host, port = srv.server_address[:2]
    print(f"serving {svc.img_size}px generator on http://{host}:{port} "
          f"(batch ladder {svc.ladder}, {device}, {args.num_devices} "
          f"device(s))", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        svc.close()


if __name__ == "__main__":
    main()

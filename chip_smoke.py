"""Smoke test of the PyTorch/CUDA port (``sagan_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port starts, builds its kernels, agrees
with its plain versions and serves.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. the card (``nvidia-smi``) and the build of every CUDA kernel from the
     sources in this checkout (``nvcc``, into ``build/kernels/``);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, in bf16 and fp32, with times of the
     kernel, the plain version and one PyTorch library call;
  3. the full-width church64 generator from a seeded init (every attention
     ``sigma`` nonzero): fp32 on the card through the kernel against fp32
     on the CPU through the plain version, and bf16 on the card finite;
  4. serving: weights written by the port's npz writer, loaded by
     ``generate.load_generator_npz``, served over HTTP by ``serve``'s
     ``GeneratorService`` at batch 64 with ladder (1, 8); the kernel
     launch counts are zeroed just before and read just after.
Then one JSON line on the kernels, the card's name and power limit, and
last the result line.  Any failure raises and exits non-zero; without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import copy
import io
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sagan_tpu_torch.convert import export_generator_npz
from sagan_tpu_torch.generate import build_serve_fn, load_generator_npz
from sagan_tpu_torch.models import get_generator
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.ops import _build, cuda_attention
from sagan_tpu_torch.ops.attention import attention_reference
from sagan_tpu_torch.serve import GeneratorService, make_server
from sagan_tpu_torch.utils.config import load_config_file, resolve_config

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "example_configs" / "church64_attn.py"
SEED = 0

# (site, N, M, d, c) of the church64 generator's two attention sites
SITES = (("64map", 4096, 1024, 2, 8), ("32map", 1024, 256, 4, 16))
# kernel vs plain: max|kernel - plain| <= TOL * max(1, max|plain|).  bf16:
# both round the output to bf16 (2^-8 relative) and the plain version also
# rounds the probabilities to bf16; fp32: the kernel sums in another order
# and uses the SFU exponential (~2 ulp).
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# whole generator, fp32 on the card vs fp32 on the CPU (tanh output in
# [-1, 1]): cuDNN and the CPU sum the convolutions in other orders
G_TOL = 1e-4

# H100 SXM data sheet (dense): bytes/s of HBM3 and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require(cond: bool, what) -> None:
    """Raise unless ``cond``: a failed check ends the run non-zero."""
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, after 3
    warm-up calls, between two CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build(cuda_attention.build_specs())
    seconds = time.perf_counter() - t0
    logs = "".join(p.with_suffix(".log").read_text() for p in paths.values())
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", logs)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", logs)]
    print(f"phase 1 build: {len(paths)} libraries ({len(regs)} kernels) in "
          f"{seconds:.1f} s; registers max {max(regs)}, spill stores max "
          f"{max(spills)} bytes", flush=True)


def attention_bound_ms(b, n, m, d, c, dtype) -> tuple[float, str]:
    """Least time for one attention call: its bytes (q, k, v read once, o
    written once) over the HBM rate, or its 2·B·N·M·(d+c) FLOPs over the
    peak for the operand type, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * b * (n * d + m * d + m * c + n * c)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * n * m * (d + c) / PEAK_FLOPS[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def phase_kernels(card: str) -> dict:
    """Kernel vs plain at both sites, B in (64, 1), bf16 and fp32.
    Returns the row of the heaviest main-path call (64 map, B=64, bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    head = None
    for b in (64, 1):
        for site, n, m, d, c in SITES:
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn(b, n, d, device="cuda", generator=gen)
                k = torch.randn(b, m, d, device="cuda", generator=gen)
                v = torch.randn(b, m, c, device="cuda", generator=gen)
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                out = cuda_attention.attention_fused(q, k, v)
                ref = attention_reference(q, k, v)
                lib = F.scaled_dot_product_attention(q, k, v, scale=1.0)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                lib_err = (lib.float() - ref.float()).abs().max().item()
                ok = err <= TOL[dtype] * max(1.0, scale)
                ms = cuda_ms(lambda: cuda_attention.attention_fused(q, k, v))
                plain_ms = cuda_ms(lambda: attention_reference(q, k, v))
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=1.0))
                bound_ms, bound_by = attention_bound_ms(b, n, m, d, c, dtype)
                name = str(dtype).removeprefix("torch.")
                print(f"phase 2 kernel attention_fwd {site} B={b} N={n} "
                      f"M={m} d={d} c={c} {name}: max_abs_err {err:.3g} "
                      f"max_rel_err {err / scale:.3g} (tol {TOL[dtype]:g} x "
                      f"max(1, max|plain|={scale:.3g})) "
                      f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms "
                      f"{plain_ms:.4f} library_ms {lib_ms:.4f} (sdpa err "
                      f"{lib_err:.3g}) bound_ms {bound_ms:.3g} ({bound_by}) "
                      f"on {card}", flush=True)
                require(ok, f"attention_fwd disagrees with the plain "
                            f"version at {site} B={b} {name}")
                if head is None:
                    head = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms,
                            "at": f"{site} B={b} N={n} M={m} d={d} c={c} "
                                  f"{name}"}
    return head


def phase_all_widths() -> None:
    """Every (dtype, d, c) instance the libraries hold, against the plain
    version at a small ragged shape (N, M not multiples of the tiles)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, count = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in cuda_attention.SUPPORTED_D:
            for c in cuda_attention.SUPPORTED_C:
                q = torch.randn(3, 100, d, device="cuda", generator=gen)
                k = torch.randn(3, 37, d, device="cuda", generator=gen)
                v = torch.randn(3, 37, c, device="cuda", generator=gen)
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                ref = attention_reference(q, k, v).float()
                out = cuda_attention.attention_fused(q, k, v).float()
                scale = max(1.0, ref.abs().max().item())
                err = (out - ref).abs().max().item() / scale
                worst = max(worst, err / TOL[dtype])
                count += 1
                require(err <= TOL[dtype], f"attention_fwd d={d} c={c} "
                        f"{dtype}: {err} > {TOL[dtype]}")
    print(f"phase 2 kernel attention_fwd, all {count} (dtype, d, c) "
          f"instances at B=3 N=100 M=37: worst error {worst:.3f} of its "
          f"tolerance", flush=True)


def church64_config(dtype: str) -> dict:
    config = resolve_config(load_config_file(str(CONFIG)))
    config.update(img_size=64, num_classes=1, compute_dtype=dtype)
    return config


def phase_generator(card: str):
    """Seeded full-width church64 G with nonzero sigma: fp32 on the card
    (kernel) vs fp32 on the CPU (plain); bf16 on the card finite."""
    gen_cpu = get_generator(church64_config("float32"),
                            rng=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for i, mod in enumerate(m for m in gen_cpu.modules()
                                if isinstance(m, SelfAttention)):
            mod.sigma.fill_(0.5 + 0.25 * i)
    z = torch.randn(8, 128, generator=torch.Generator().manual_seed(SEED))
    labels = torch.zeros(8, dtype=torch.long)
    gen_gpu = copy.deepcopy(gen_cpu).to("cuda")
    with torch.inference_mode():
        want = gen_cpu(z, labels)
        before = cuda_attention.LAUNCHES
        got = gen_gpu(z.cuda(), labels.cuda()).cpu()
        launches = cuda_attention.LAUNCHES - before
    err = (got - want).abs().max().item()
    print(f"phase 3 generator fp32 card vs cpu: shape {tuple(got.shape)} "
          f"max_abs_err {err:.3g} (tol {G_TOL:g}), attention launches "
          f"{launches}", flush=True)
    require(err <= G_TOL and launches == 2 and got.shape == (8, 3, 64, 64),
            "fp32 generator on the card disagrees with the CPU, or did not "
            "launch the kernel twice")

    gen16 = get_generator(church64_config("bfloat16"))
    gen16.load_state_dict(gen_cpu.state_dict())
    gen16.to("cuda")
    with torch.inference_mode():
        x16 = gen16(z.cuda(), labels.cuda()).float().cpu()
        u8 = build_serve_fn(gen16)(z.cuda(), labels.cuda()).cpu()
    finite = bool(torch.isfinite(x16).all())
    in_range = bool(x16.abs().max() <= 1.0)
    print(f"phase 3 generator bf16 on {card}: finite {finite}, |x| <= 1 "
          f"{in_range}, max |bf16 - fp32| {(x16 - want).abs().max():.3g}, "
          f"uint8 {tuple(u8.shape)} {u8.dtype}", flush=True)
    require(finite and in_range and u8.shape == (8, 64, 64, 3)
            and u8.dtype == torch.uint8,
            "bf16 generator output is not finite images")
    return gen_cpu


def _get(url: str):
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as r:
        body = r.read()
        return r.status, dict(r.headers), body, time.perf_counter() - t0


def phase_serve(gen32, card: str) -> int:
    """Serve the church64 G over HTTP; returns the kernel launches."""
    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    config = church64_config("bfloat16")
    weights = export_generator_npz(gen32, str(smoke_dir / "church64_g.npz"),
                                   config)

    cuda_attention.LAUNCHES = 0      # the main path starts here
    t0 = time.perf_counter()
    gen = load_generator_npz(config, weights, "cuda")
    svc = GeneratorService(gen, z_dim=config["z_dim"], num_classes=1,
                           batch=64, ladder=(1, 8))
    startup_s = time.perf_counter() - t0
    forwards = len(svc.ladder)
    srv = make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        status, _, body, healthz_s = _get(base + "/healthz")
        require((status, body) == (200, b"ok"), (status, body))
        status, _, body, meta_s = _get(base + "/meta")
        meta = json.loads(body)
        require(status == 200 and meta["img_size"] == 64
                and meta["ladder"] == [1, 8, 64], meta)
        print(f"phase 4 serve: startup {startup_s:.2f} s (weights load + "
              f"ladder {svc.ladder} warm-up); /healthz 200 ok "
              f"{healthz_s * 1e3:.2f} ms; /meta 200 {meta_s * 1e3:.2f} ms "
              f"{meta} on {card}", flush=True)

        raw = {}
        for n in (1, 8, 64):
            times = []
            for rep in range(5):
                status, headers, body, sec = _get(
                    f"{base}/sample?n={n}&seed={rep}&format=raw")
                forwards += len(list(svc._chunks(n)))
                imgs = np.frombuffer(body, np.uint8).reshape(n, 64, 64, 3)
                require(status == 200
                        and headers["X-Image-Shape"] == f"{n}x64x64x3"
                        and headers["X-Image-Dtype"] == "uint8", headers)
                require(imgs.std() > 0, "served images are constant")
                times.append(sec * 1e3)
                raw[n, rep] = body
            print(f"phase 4 serve /sample?n={n}&format=raw: 200, "
                  f"{n}x64x64x3 uint8; latency ms median "
                  f"{statistics.median(times):.2f} of {len(times)} "
                  f"({', '.join(f'{t:.2f}' for t in times)}) on {card}",
                  flush=True)
        status, _, body, sec = _get(f"{base}/sample?n=8&seed=2&format=raw")
        forwards += len(list(svc._chunks(8)))
        require(body == raw[8, 2], "same seed gave other bytes")
        print(f"phase 4 serve: seed 2 again gives identical bytes "
              f"({sec * 1e3:.2f} ms)", flush=True)
        status, headers, body, sec = _get(f"{base}/sample?n=16&seed=7")
        forwards += len(list(svc._chunks(16)))
        from PIL import Image
        grid = Image.open(io.BytesIO(body))
        require(status == 200 and headers["Content-Type"] == "image/png"
                and grid.size == (262, 262), (status, headers, grid.size))
        print(f"phase 4 serve /sample?n=16 png: 200, grid {grid.size} "
              f"({sec * 1e3:.2f} ms on {card})", flush=True)
        status, _, body, _ = _get(base + "/metrics")
        require(status == 200 and b"sagan_images_total" in body, body)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=30)
    launches = cuda_attention.LAUNCHES   # the main path ends here
    print(f"phase 4 serve: attention_fwd launches {launches} for {forwards} "
          f"generator forwards (2 attention sites each)", flush=True)
    require(launches == 2 * forwards,
            f"expected {2 * forwards} kernel launches, counted {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    phase_build()
    head = phase_kernels(card)
    phase_all_widths()
    gen32 = phase_generator(card)
    launches = phase_serve(gen32, card)
    kernels = [{"name": "attention_fwd", "route": "cuda",
                "source": "sagan_tpu_torch/csrc/attention_fwd.cu",
                "replaces": "sagan_tpu/ops/pallas_attention.py:157",
                "launches": launches, **head}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

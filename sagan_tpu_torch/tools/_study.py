"""What the attention studies share (``bench_attn_floor``,
``bench_attn_floor256``, ``bench_attn_bwd256``, ``bench_attn_floor512``):
their shapes and seeded data, the card line, the flags, timing, the
sweep runner, and ``step_segments``, a training step's time with and
without attention.

Every study takes ``--quick`` (the shipped tile point and one other of
every sweep, 3 timed iterations) and, for the CPU tests only, ``--device
cpu --tiny``, which runs the plain versions at a tiny shape to test the
wiring and measures nothing (its times are null).  With neither, a study
needs a card and raises without one.  Each prints the card line first,
then one line per measurement, and last one JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.attention import attention_flash_reference
from ..ops.attention_study import study_attention_reference
from ..ops.cuda_attention import attention_flash_fwd
from ..ops.cuda_attention_study import (FWD_POINTS, MMA_DEFINES, MMA_POINTS,
                                        attention_study, fwd_tiles)
from ..utils.config import load_config_file, resolve_config
from ..utils.device import resolve_device
from ..utils.timing import cuda_time_ms

# [B, N, M, d, c] of every study: church64 G's 64 map, church256 G's 256
# map, church512 G's 512 map (d = c / 8 = 2 at each)
SHAPES = {"64": (64, 4096, 1024, 2, 8), "256": (16, 65536, 16384, 2, 8),
          "512": (4, 262144, 65536, 2, 8)}
TINY = (2, 64, 48, 2, 8)
CIN = 16  # channels of those maps in the gf16 generators (x -> theta/phi/g)
QUICK = (3, 1, 1)  # iters, reps, warmup of --quick and --tiny
# a kernel against another computing the same function in bf16: both
# round the output to bf16 (2^-8 relative) and may round P differently
BF16_TOL = 8e-3
# a backward kernel against the plain backward in bf16, per output: both
# round the outputs to bf16, and the plain version also rounds dL and P to
# bf16 on the way, as the TPU kernels do (chip_smoke's BWD_TOL)
BWD_TOL = 2e-2
# the flash studies' floors: the study forward's default, no max, no
# transcendental, on both engines, and the shipped K3 (mma_exp2: the
# tensor-core floors are its builds)
FLOORS = ("fma", "fma_nomax", "fma_noexp", "mma", "mma_nomax", "mma_noexp",
          "mma_exp2")
# the query rows at which every study holds what it timed against the
# plain version (``held``): the first CHECK_ROWS of batch 0 and the last
# LAST_ROWS (a query block of every kernel) of the last batch element
CHECK_ROWS, LAST_ROWS = 2048, 64
# SDPA's backends that do not materialise the logits, and the width its
# flash and memory-efficient kernels take q and k at (d = 2 zero-padded)
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION]
SDPA_WIDTH = 8

ROOT = Path(__file__).resolve().parents[2]
CHURCH512 = ROOT / "example_configs" / "church512_attn.py"
# the JAX package's 256 px flash-regime config (bench.py CHURCH256): N =
# 65,536 queries, M = 16,384 keys at G's 256 map
CHURCH256 = {
    "model": "vanilla",
    "z_dim": 128,
    "gf_dim": 16,
    "df_dim": 16,
    "img_size": 256,
    "use_attention": True,
    "attn_dim_G": [256],
    "attn_dim_D": [64],
    "use_label": False,
    "num_classes": 1,
    "lr_g": 2e-4,
    "lr_d": 7e-4,
    "decay_rate": 0.99,
    "update_ratio": 1,
    "loss": "hinge_loss",
    "num_devices": 1,
    "batch_size": 16,
    "global_batch_size": 16,
}


def card_line() -> str:
    """The card's name, power limit and maximum SM clock."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def church256_config() -> dict:
    return resolve_config(dict(CHURCH256, data_path="",
                               compute_dtype="bfloat16"))


def church512_config() -> dict:
    config = resolve_config(load_config_file(str(CHURCH512)))
    config.update(img_size=512, num_classes=1)
    return config


def max_delta(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """max|got − want| beside its limit ``tol`` × max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    limit = tol * want.float().abs().max().item()
    return {"max_abs_err": err, "limit": limit, "ok": err <= limit}


def held(got: torch.Tensor, plain, queries: tuple, keys: tuple,
         tol: float = BF16_TOL) -> dict:
    """``max_delta`` of a kernel's output ``got`` [B, N, c], at the full
    shape it was timed at, against ``plain(*queries, *keys)`` on the check
    rows: the first ``CHECK_ROWS`` query rows of batch 0 and the last
    ``LAST_ROWS`` of batch B − 1, each against all keys of its batch
    element.  ``queries`` are the [B, N, *] inputs, ``keys`` the [B, M, *]
    ones; the plain version costs what those rows cost, not the map."""
    b, n = got.shape[:2]
    parts = ((0, slice(0, min(n, CHECK_ROWS))),
             (b - 1, slice(max(0, n - LAST_ROWS), n)))
    kept, want = [], []
    for bi, rows in parts:
        kept.append(got[bi:bi + 1, rows])
        want.append(plain(*(t[bi:bi + 1, rows] for t in queries),
                          *(t[bi:bi + 1] for t in keys)))
    return max_delta(torch.cat(kept, 1), torch.cat(want, 1), tol)


def sdpa_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                grad: torch.Tensor | None = None):
    """``scaled_dot_product_attention(scale=1.0)`` on [B, 1, L, E] views
    with q and k zero-padded to ``SDPA_WIDTH`` (the logits do not change),
    on a backend that does not materialise the [B, N, M] logits (on the
    card; none takes d = 2 as given, and the math backend's time is not
    the library's): the library call beside the kernels.  With ``grad``
    (the output's cotangent, [B, N, c]) a function of no arguments that
    runs its backward through autograd instead of the forward."""
    pad = max(0, SDPA_WIDTH - q.shape[2])
    qp, kp = (F.pad(t.unsqueeze(1), (0, pad)) for t in (q, k))
    vp = v.unsqueeze(1)
    backends = SDPA_BACKENDS if q.is_cuda else [SDPBackend.MATH]
    if grad is None:
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(qp, kp, vp,
                                                  scale=1.0).squeeze(1)
    qp, kp, vp = (t.detach().requires_grad_() for t in (qp, kp, vp))
    with sdpa_kernel(backends):
        out = F.scaled_dot_product_attention(qp, kp, vp, scale=1.0)
    g4 = grad.unsqueeze(1)
    return lambda: torch.autograd.grad(out, (qp, kp, vp), g4,
                                       retain_graph=True)


class Study:
    """One study's run: its flags, device, shape, timing and results.

    ``shape`` is the study's [B, N, M, d, c]; ``timing`` its (iters, reps,
    warmup) of a full run."""

    def __init__(self, name: str, shape: tuple, argv, timing: tuple,
                 doc: str):
        ap = argparse.ArgumentParser(prog=name, description=doc)
        ap.add_argument("--quick", action="store_true",
                        help="the shipped tile point and one other of "
                             "every sweep, 3 timed iterations")
        ap.add_argument("--device", default="cuda",
                        help="cuda (default); cpu only with --tiny")
        ap.add_argument("--tiny", action="store_true",
                        help="a tiny shape, for the CPU tests: measures "
                             "nothing")
        args = ap.parse_args(argv)
        self.device = resolve_device(args.device)
        self.on_card = self.device.type == "cuda"
        # the engine argument of K3 and K6: named on the card only (CPU
        # tensors run the plain versions and refuse an engine)
        self.fma = "fma" if self.on_card else None
        self.mma = "mma" if self.on_card else None
        if not self.on_card and not args.tiny:
            raise ValueError(f"{name} runs on the CPU only with --tiny (the "
                             f"wiring test); its shapes need a card")
        self.name = name
        self.quick = args.quick or args.tiny
        self.tiny = args.tiny
        self.shape = TINY if args.tiny else shape
        self.iters, self.reps, self.warmup = QUICK if self.quick else timing
        self.card = card_line() if self.on_card else "cpu: nothing measured"
        self.sections: dict = {}
        if self.on_card:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        print(self.card, flush=True)
        b, n, m, d, c = self.shape
        print(f"{name}: B={b} N={n} M={m} d={d} c={c} bf16 on "
              f"{self.device}; {self.iters} back-to-back calls between CUDA "
              f"events (L2-warm), median and min of {self.reps}, after "
              f"{self.warmup}", flush=True)

    def points(self, points: tuple) -> tuple:
        """The sweep points to run: all, or the shipped one and the next."""
        return points[:2] if self.quick else points

    def data(self, batch: int | None = None):
        """q, k, v, g of the study's shape (at ``batch`` in place of its B)
        in bf16 from numpy's default_rng(0), drawn as the JAX studies draw
        theirs."""
        b, n, m, d, c = self.shape
        b = batch or b
        rng = np.random.default_rng(0)
        return [torch.from_numpy(rng.standard_normal(s)).to(self.device,
                                                            torch.bfloat16)
                for s in ((b, n, d), (b, m, d), (b, m, c), (b, n, c))]

    def time(self, fn, *args) -> dict:
        """{"ms", "min_ms"} of ``fn(*args)`` on the card; on the CPU one
        call, to run the wiring, and nulls."""
        if not self.on_card:
            fn(*args)
            return {"ms": None, "min_ms": None}
        ms, least = cuda_time_ms(fn, *args, iters=self.iters,
                                 reps=self.reps, warmup=self.warmup)
        return {"ms": ms, "min_ms": least}

    def record(self, section: str, key: str, row: dict,
               note: str = "") -> dict:
        """Keep ``row`` as ``sections[section][key]`` and print it."""
        self.sections.setdefault(section, {})[key] = row
        text = " ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in row.items())
        print(f"{section}/{key}: {text}{note}", flush=True)
        return row

    def sweep(self, section: str, points: tuple, make) -> tuple:
        """Time ``fn(*args)`` of ``make(point) -> (fn, args, extra)`` at
        each point (``extra``: more keys of the row), the first marked
        ``<- shipped``; returns the fastest point (the shipped one on the
        CPU)."""
        times = {}
        for i, point in enumerate(self.points(points)):
            fn, args, extra = make(point)
            row = {"point": list(point), **self.time(fn, *args), **extra,
                   "shipped": i == 0}
            self.record(section, "x".join(map(str, point)), row,
                        " <- shipped" if i == 0 else "")
            times[point] = row["ms"]
        best = points[0] if not self.on_card else min(times, key=times.get)
        self.record(section, "best", {"point": list(best),
                                      "ms": times[best],
                                      "shipped_ms": times[points[0]]})
        return best

    def finish(self) -> dict:
        """Print the JSON of every measurement; raise if a max|Δ| passed
        its limit."""
        result = {"study": self.name, "card": self.card,
                  "device": str(self.device), "shape": list(self.shape),
                  "quick": self.quick, "sections": self.sections}
        print(json.dumps(result), flush=True)
        bad = [f"{s}/{k}" for s, rows in self.sections.items()
               for k, row in rows.items() if row.get("ok") is False]
        if bad:
            raise AssertionError(f"{self.name}: past the limit: {bad}")
        return result


def held_variant(out, q, k, v, variant: str) -> dict:
    """``held`` of the study forward ``variant``'s output ``out`` against
    its plain version."""
    return held(out, lambda q, k, v: study_attention_reference(q, k, v,
                                                               variant),
                (q,), (k, v))


def floors(st: Study, q, k, v, best: tuple) -> None:
    """The ``FLOORS`` variants of the study forward on q, k, v, the fma
    engine at forward tile point ``best`` (the mma engine is the shipped
    K1/K3 body with its own tiles), each held against its plain
    version."""
    for variant in FLOORS:
        fma = variant.startswith("fma")
        args = (q, k, v, variant, fwd_tiles(best) if fma else ())
        st.record("floors", variant, {
            "point": list(best) if fma else "K1/K3 build",
            **st.time(attention_study, *args),
            **held_variant(attention_study(*args), q, k, v, variant)})


def k3_sweep(st: Study, q, k, v) -> tuple:
    """The ``k3_tiles`` sweep: K3 on the CUDA cores (its first design,
    ``engine="fma"``) at each forward tile point, each held against the
    plain forward whose arithmetic it has (fp32 P: the study's ``fma``);
    returns the fastest point."""
    def point(p):
        tiles = fwd_tiles(p)
        o = attention_flash_fwd(q, k, v, tiles, st.fma)[0]
        return attention_flash_fwd, (q, k, v, tiles, st.fma), held_variant(
            o, q, k, v, "fma")

    return st.sweep("k3_tiles", FWD_POINTS, point)


def k3_mma_sweep(st: Study, q, k, v) -> tuple:
    """The ``k3_mma`` sweep: the shipped tensor-core K3, then K3 with one
    design choice flipped a point (``MMA_POINTS``), each held against the
    plain flash forward; returns the fastest point."""
    def point(p):
        tiles = MMA_DEFINES[p]
        o = attention_flash_fwd(q, k, v, tiles, st.mma)[0]
        return attention_flash_fwd, (q, k, v, tiles, st.mma), held(
            o, lambda q, k, v: attention_flash_reference(q, k, v)[0], (q,),
            (k, v))

    return st.sweep("k3_mma", MMA_POINTS, point)


def step_segments(study: Study, config: dict, steps: int) -> dict:
    """A training step of ``config`` (``--tiny``: cut to 32 px, B = 2)
    with attention, then without: ms a step on the host clock to the
    card's end, after 2 warm-up steps, and the attention share of the
    step, 1 − off/on (null on the CPU)."""
    from .train_breakdown import build_step

    if study.tiny:
        config = dict(config, img_size=32, attn_dim_G=[32], attn_dim_D=[8],
                      batch_size=2, global_batch_size=2)
        steps = 1
    ms = {}
    for attn in (True, False):
        _, run = build_step(dict(config, use_attention=attn), study.device)
        for _ in range(2):
            run()
        if study.on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        if study.on_card:
            torch.cuda.synchronize()
            ms[attn] = (time.perf_counter() - t0) * 1e3 / steps
        else:
            ms[attn] = None
        del run
    share = None if ms[True] is None else 1.0 - ms[False] / ms[True]
    return {"batch": config["global_batch_size"],
            "img_size": config["img_size"], "steps": steps,
            "with_attention_ms": ms[True], "without_attention_ms": ms[False],
            "attention_share": share}

"""Smoke test of the PyTorch/CUDA port (``sagan_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port starts, builds its kernels, agrees
with its plain versions, serves and trains.

    python3 chip_smoke.py [--only PHASE ...]

Phases, each printed as it ends (``--only`` runs the phases named, after
the build, and prints neither the kernels line nor the result line):
  1. the card (``nvidia-smi``) and the build of every CUDA kernel from the
     sources in this checkout (``nvcc``, into ``build/kernels/``);
  2. the attention forward (K1) against its plain PyTorch version on the
     card, at G's sites at the serving batches and D's at the training
     batches (church64's, church512's D site, imagenet128_cond's four),
     bf16 on both engines (the tensor cores, ``mma``, bf16's engine, and
     the CUDA cores, ``fma``) and fp32 on the CUDA cores, with times of
     each kernel, the plain version and the library calls (SDPA as given
     and, in bf16, SDPA on q and k zero-padded to 8, which takes a
     backend that does not materialise the logits: K1's library column),
     in bf16 also each engine's kernels alone from a profiler trace (the
     events read the host's enqueue at the small sites), and every
     (dtype, engine, d, c) instance at phase 9's ragged shapes;
  3. the full-width church64 generator from a seeded init (every attention
     ``sigma`` nonzero): fp32 on the card through the kernel against fp32
     on the CPU through the plain version, and bf16 on the card finite;
  4. serving: weights written by the port's npz writer, loaded by
     ``generate.load_generator_npz``, served over HTTP by ``serve``'s
     ``GeneratorService`` at batch 64 with ladder (1, 8); the kernel
     launch counts are zeroed just before and read just after (the
     tensor-core K1 twice a forward, no other kernel);
  5. the attention backward (K2) against its plain version at phase 2's
     training sites, bf16 on both engines and fp32 on the CUDA cores,
     with times (the library call is autograd through
     ``scaled_dot_product_attention``, and in bf16 through it on q and k
     zero-padded to 8: K2's library column); in bf16 each engine's
     kernels alone from a profiler trace, the tensor-core K2's key blocks
     against the port's copy of their rule and two calls bit for bit; and
     every (dtype, engine, d, c) instance at phase 9's ragged shapes;
  6. one fp32 training step of the full-width church64 G and D (every
     attention ``sigma`` nonzero) on the card against the same step on the
     CPU, twice: with D's learning rate 0, losses and all per-variable
     gradient norms agree and every attention theta/phi/g weight has a
     nonzero gradient; with the config's learning rates, D's loss and
     gradient norms (taken before D's update) agree, and so do G's and D's
     parameters, buffers and the EMA after the step.  The card's steps
     take cuDNN's deterministic algorithms.  Each step launches
     the CUDA-core K1 8 times and K2 6 times, fp32's engine;
  7. training through the entry point (``python -m sagan_tpu_torch.main``
     in-process): the church64 config in bf16 at batch 64 with
     ``steps_per_call`` 8 on 64 px synthetic TFRecords written by the
     port's own writer under ``build/smoke/``, 2 epochs, with per-epoch
     imgs/s and ms/step and launch counts (the tensor-core K1 8 and K2 6
     per step, K1 2 per sample-grid forward, none on the CUDA cores;
     zeroed just before, read just after); a
     restart that restores the checkpoint and trains a third epoch (both
     on the default ``device_cache: "auto"``: the dataset on the card);
     ``generate`` sampling the checkpoint's EMA generator; and ``generate
     --step`` on the first saved step equal to sampling that checkpoint
     loaded directly, a step not saved raising ``KeyError``;
  8. the flash kernels at the church512 512-map site (N=262144, M=65536,
     d=2, c=8) at the config's B=4 and at B=8 (phase 13's; past the slab
     budget in fp32), bf16 and fp32: the forward K3 (o and lse), the
     backward kernels K4, K5 and K6 on K3's (o, lse), each on the dtype's
     engine (bf16: the tensor cores, ``csrc/attention_flash_mma.cu``) and
     in bf16 also on the CUDA cores (``engine="fma"``), each against its
     plain version run in query-row chunks, K6 against K4 + K5, the
     tensor-core K5's dk and dv against K6's bit for bit and two
     tensor-core K4 + K5 pairs bit for bit, and in fp32 each dq against
     float64 on the rows where they differ most; at both batches with
     times of the kernels, the K4 + K5 pair, the plain versions and
     ``scaled_dot_product_attention`` on a backend that does not
     materialise the logits (q and k zero-padded to a width it takes;
     its backward through autograd is the pair's yardstick); then both
     engines of K3 and K6 timed at church256's 256 map (B=16), held
     against the plain versions on the studies' check rows;
  9. every K6 key block against the one the route rule counts, and K3-K6
     (K4 + K5 as the two-kernel backward runs them) at every (dtype,
     engine, d, c) instance at three ragged shapes: N and M off every
     tile, M under one key tile with N under 16, and M past K6's key
     block, the tensor-core K5's dk and dv equal to K6's;
 10. ``FlashAttention`` gradients at a small flash-routed shape against
     autograd through the plain forward, on the card: bf16 through the
     tensor-core K3 and K6, fp32 through the CUDA-core ones, then with
     the slab budget set to 0, through K4 + K5 of each engine;
 11. serving church512: the fp32 generator at 512 px (BN statistics of
     one batch, as an untrained G's eval output is flat) through the
     CUDA-core K3 against the same weights with ``use_pallas=False`` (the
     chunked plain forward), then the bf16 generator over HTTP at n = 1
     and 4, with the launches zeroed just before and read just after:
     the tensor-core K3 once a forward, no other kernel;
 12. training church512 through the entry point on 64 synthetic 512 px
     records for one epoch at the config's B=4, ``steps_per_call`` 4, with
     exact launch counts (the tensor-core K3 2 a step and 1 a grid, the
     tensor-core K6 1 a step, the tensor-core K1 and K2 2 a step, no
     CUDA-core kernel)
     and nonzero gradients of the 512 site's theta/phi/g;
 13. one church512 training step at B=8: in bf16 its G backward takes
     the tensor-core K6 (2,048 keys a block: 536.9 MB of dq partials,
     inside ``DQ_SLAB_BUDGET``), with exact launch counts (the tensor-core
     K1, K2 and K3 2 each, K6 1, no CUDA-core kernel); then at B=16 in
     bf16, past the budget (1.07 GB), the tensor-core K4 and K5 1 each in
     K6's place; then at B=8 in fp32, past the budget at the CUDA-core
     K6's 1,024 keys a block (1.07 GB: the CUDA-core K1, K2, K3 2 each, K4
     and K5 1 each);
 14. the grouped spectral norm K7 against its plain version on the card,
     over G's and D's whole tables of SN weights of imagenet128_cond and
     imagenet128_paper_gf64 (one grouped call a table, up to the [1128,
     16384] stem), fp32: W_bar, u_new, v and sigma per weight, u stored
     where asked and only there, the bf16 W_bar the fp32 one rounded,
     two calls bit for bit; the grouped backward (fp32 and bf16 g, one
     weight given none) against the closed form per weight; the gradient
     through ``SpectralNormGroup`` against autograd through the plain
     function; n_iter 2 and mixed; times of a grouped call over each
     imagenet128_cond table (bf16 and fp32 W_bar, both launch designs,
     the backward), L2 flushed and warm, beside their bounds, and of a
     group of one at the G stem;
 15. the full-width imagenet128_cond generator in fp32 on the card with
     ``use_pallas_sn`` (one grouped K7 call for its 25 SN weights)
     against the same generator with the plain SN;
 16. training imagenet128_cond (ResNet G and D, 1000 classes, update
     ratio 2) with ``use_pallas_sn`` through the entry point on 512
     synthetic labelled 128 px records for 2 epochs, and a restart for a
     3rd, with exact K7 (6 grouped calls for 159 weights and 3 grouped
     backward calls a step, 1 call a sample grid), K1 and K2 (tensor
     cores) launch counts;
 17. serving that checkpoint over HTTP per ``class_id`` at n = 1 and 8;
 18. one bf16 imagenet128_paper_gf64 training step at B=64 with
     ``use_pallas_sn``;
 19. one epoch of the legacy CLI (``sagan_tpu_torch.legacy_main``) on the
     same records;
 20. the attention study kernels: every study library built (one nvcc
     each, all together); every variant of the study forward (S1) against
     its plain version at church64's 64 map, a 4,096-row chunk of the 256
     and 512 maps and a ragged shape, bf16 and (fma engine) fp32, its fma
     default against the CUDA-core K1 bit for bit and its ``mma_exp2``
     (its tensor-core variants are builds of the shipped K1/K3 body)
     against the shipped tensor-core K1 or K3 bit for bit; S1's
     tensor-core variants timed at the 64, 256 and 512 maps whole beside
     ``sdpa_padded``; both forms of the folded forward (S2, bf16 on the
     tensor cores) against theirs, and S2 timed at the 64 and 256 maps
     beside the shipped kernel on projected q, k; the CUDA-core K1 and K3
     at every forward tile point against the plain forward, K4-K6 at every
     backward tile point against K4 + K5 at the shipped tiles (B=2 at the
     256 map); the tensor-core K1 and K2 at every design flip of the
     64-map study against the plain versions, K4 + K5 at every flip of
     the backward studies against the plain backward, and K6 at every
     (query tile, key block) point of theirs against the plain backward
     and the shipped K4 + K5, its partials sized by its own library and
     the K2, K4 and K5 of its library equal to the shipped ones bit for
     bit (B=2 at the 256 map and two ragged shapes);
 21. the four attention studies (``sagan_tpu_torch.tools.bench_attn_*``)
     with ``--quick`` in process: every section present, every time > 0,
     every max|Δ| within its limit (each kernel a study times, at the full
     study shape it times it at, against its plain version on the first
     2,048 query rows of batch 0 and the last 64 of the last batch
     element; the tile variants of K4-K6 against K4 + K5), the study
     kernels launched;
 22. the church64 feeds at full width on phase 7's records: the CLI on the
     host feed (``device_cache: False``) for 2 epochs, then on the device
     cache (the default "auto") for 2 and a restart for a 3rd, each
     epoch's first call gathered on the card equal byte for byte to the
     host feed's, each feed's epoch imgs/s; one streaming epoch
     (``cache_dataset: False``, ``shuffle_buffer`` 512) through the native
     reader equal to the pure-Python reader's, the decode rates of both
     readers at ``data_workers`` 1 and 4 (the records in 8 shards); the
     image folder (``use_image_generator``, 256 generated PNGs in two
     class folders) trained through the tensor-core K1 and K2;
 23. one church512 step at B = 8 in bf16 with and without ``remat`` from
     the same state: losses, gradient norms, u and BN stats held within
     stated tolerances, launches (under remat K1 4 and K3 3: the stages'
     attention runs again in the backward; K2 2, K6 1, as without),
     device ms and peak memory of each; then the same step with
     ``grad_accum_steps`` 2, whose micro-batches of 4 take K6 too;
 24. imagenet128_cond with ``use_pallas_sn`` in bf16 at batch 256 with
     ``grad_accum_steps`` 4: the G update's accumulated gradients against
     its four micro-batches' taken one at a time, the finalized BN stats
     against the momentum update of their averaged moments, launches 4x a
     batch-64 step's (each micro-batch of 64 takes phase 16's routes),
     device ms and peak memory beside batch 64;
 25. evaluation: church64 at full width through the entry point for one
     epoch of 32 calls (``steps_per_call`` 1) on phase 7's records with an
     FID epoch (5,000 images through the proxy, then the proxy IS): its
     host seconds split into real and fake statistics, fake images/s, and
     its launches (the tensor-core K1 2 a G forward, no other kernel);
     the profiler window's trace holding the K1 and K2 kernels of calls
     [10, 20) exactly, the event file's ``hist/`` summaries; ``evaluate``
     on its checkpoint with and without ``--raw_g`` (equal FIDs: below
     ``g_ema_start`` the EMA is G); the proxy extractor and classifier on
     the card against the CPU; InceptionV3 at full width (299 px) on an
     npz of random weights against the CPU, timed per 64 images, and
     ``evaluate`` through it; ``evaluate`` on phase 16's imagenet128_cond
     checkpoint (one grouped K7 call and K1 2 a G forward);
 26. data parallelism on the one card, every group of ranks started by
     ``torch.distributed.run``: (a) ``sagan_tpu_torch.main`` on church64
     at full width in bf16 in a one-rank NCCL group for 2 epochs of 20
     steps, bit for bit equal to the same run without a group, with the
     same launches (the tensor-core K1 8 and K2 6 a step; the group's read
     from its profiler window of calls [10, 20)), the second epoch's ms a
     step both ways and the window's all-reduces from its trace; (b) two
     gloo ranks sharing ``cuda:0`` (this script as their worker,
     ``--rank-jobs``) at a per-rank batch of 64 against one process at
     128 on the same images and seed: church64 (4 steps) and
     imagenet128_cond with ``use_pallas_sn`` (2 steps), fp32 and bf16,
     beside a control (one process, the real images reversed: the card's
     own noise of a reordered sum), the first fp32 step with D frozen at
     1e-4 (cuDNN's deterministic algorithms), and church64's fp32 runs
     again with a planted fault in the BN moments' backward, which both
     must catch; the ranks'
     states bit for bit, the launches per rank (K1 8 / K2 6, K1 12 / K2 8
     and K7 6 grouped calls and 3 backward calls a step); (c)
     ``sagan_tpu_torch.main`` on two gloo ranks over phase 7's records in
     3 uneven shards: an epoch on the host feed and one on the device
     cache, bit for bit, each rank taking ``steps_per_epoch`` steps, a
     checkpoint written by rank 0 and restored on both for another epoch;
     (d) ``GeneratorService`` at ``num_devices`` 1 serving phase 4's
     bytes, two replicas on the card serving the one-device images, and
     ``serve --num_devices 2`` on one card raising.
 27. model parallelism (``model_parallel`` 2) on the one card, two gloo
     ranks sharing ``cuda:0`` as a 1 x 2 grid, on example_configs/
     biggan128_pod.py at full width (128 px, 1,000 classes, gf = df = 32,
     attention at G's and D's 64 maps): (a) the ranks at a global batch of
     8 against one process at 8 on the same seeded init and images: the
     first fp32 step with D frozen at 1e-4 (BN stats and SN u 1e-5;
     cuDNN's deterministic algorithms), four
     steps at the config's learning rates, fp32 and bf16, at 26b's limits
     or 4x the worst of three reordered-images controls' readings,
     whichever is larger, the ranks' whole states bit for bit; (b) what each rank holds (parameter, Adam and
     EMA bytes against one process), its peak memory and ms a step, and
     its K1/K2 launches a step against one process's, K7 none; (c) an
     ImageNet-layout folder of 1,000 class directories converted by
     ``python -m sagan_tpu_torch.data.convert``, one epoch of 64 records
     through ``sagan_tpu_torch.main`` on the two ranks in bf16 (JAX's SN
     message printed; the ranks' digest of the whole state equal to the
     checkpoint rank 0 wrote), a restart that resumes from it, and
     ``generate`` sampling its EMA G in one process at model_parallel 1;
     (d) two planted faults (the gradient mean over the world instead of
     the data group; the gathered output's backward summing instead of
     slicing), each of which the frozen step must catch.
Then one JSON line on the kernels, the card's name and power limit, and
last the result line.  Any failure raises and exits non-zero; without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from sagan_tpu_torch import generate, legacy_main
from sagan_tpu_torch import main as train_cli
from sagan_tpu_torch.convert import export_generator_npz
from sagan_tpu_torch.data.loader import ImageDataset
from sagan_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                            synthetic_images)
from sagan_tpu_torch.generate import build_serve_fn, load_generator_npz
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn import layers
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.ops import _build
from sagan_tpu_torch.ops import attention as attention_ops
from sagan_tpu_torch.ops import (cuda_attention, cuda_attention_study,
                                 cuda_spectral)
from sagan_tpu_torch.ops.attention import (attention, attention_bwd_reference,
                                           attention_flash_bwd_reference,
                                           attention_flash_reference,
                                           attention_reference,
                                           MMA_K6_WARPS, flash_bwd_fused,
                                           fused_keys_per_block, k2_key_blocks,
                                           k6_warps, mma_key_tiles,
                                           plain_chunk, single_pass)
from sagan_tpu_torch.ops.attention_study import (VARIANTS, folded_reference,
                                                 study_attention_reference)
from sagan_tpu_torch.ops.cuda_attention_study import mma_entry
from sagan_tpu_torch.ops.spectral import spectral_normalize
from sagan_tpu_torch.parallel import mesh, sharding
from sagan_tpu_torch.serve import GeneratorService, make_server
from sagan_tpu_torch.serve import main as serve_main
from sagan_tpu_torch.tools import (bench_attn_bwd256, bench_attn_floor,
                                   bench_attn_floor256, bench_attn_floor512)
from sagan_tpu_torch.train.checkpoint import CheckpointManager
from sagan_tpu_torch.train.optim import make_gan_optimizers
from sagan_tpu_torch.train.trainer import (TrainState, Trainer, TrainStep,
                                           build_train_step,
                                           model_parallel_routing)
from sagan_tpu_torch.tools._study import held, max_delta, sdpa_padded
from sagan_tpu_torch.tools.profiling import (kernel_ms_per_call,
                                             ms_or_not_measured,
                                             ratio_or_not_measured)
from sagan_tpu_torch.utils.config import load_config_file, resolve_config
from sagan_tpu_torch.utils.timing import cuda_time_ms

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "example_configs" / "church64_attn.py"
SEED = 0

# (site, N, M, d, c, batches) of every attention site of a church64
# training step: G's at B=64, D's at B=128 (fused real+fake D update) and
# B=64 (G update); then church512's D site, which K1/K2 take too, at the
# batches of its training steps: B=8 and 4 at the config's B=4 (phase 12),
# B=16 and 8 in the B=8 step (phase 13)
TRAIN_SITES = (("G 64map", 4096, 1024, 2, 8, (64,)),
               ("G 32map", 1024, 256, 4, 16, (64,)),
               ("D 8map", 64, 16, 8, 32, (128, 64)),
               ("D 4map", 16, 4, 16, 64, (128, 64)),
               ("church512 D 64map", 4096, 1024, 8, 32, (16, 8, 4)),
               # imagenet128_cond's (qk = ch/8, v = ch/2 at gf = df = 16)
               # at its B=64: G's sites, D's at B=128 (the fused D update)
               # and B=64 (G's update)
               ("imagenet128 G 64map", 4096, 1024, 4, 16, (64,)),
               ("imagenet128 G 32map", 1024, 256, 8, 32, (64,)),
               ("imagenet128 D 64map", 4096, 1024, 2, 8, (128, 64)),
               ("imagenet128 D 32map", 1024, 256, 4, 16, (128, 64)))
# the engines each dtype's K1 and K2 are held on: bf16 runs the tensor
# cores on the model's path, and the CUDA-core kernels beside them
ENGINES = {torch.bfloat16: ("mma", "fma"), torch.float32: ("fma",)}
# the forward's calls held against its plain version: G's sites at the
# serving batches 64 and 1, D's at the training batches
FWD_CALLS = tuple((site, n, m, d, c, b)
                  for site, n, m, d, c, batches in TRAIN_SITES
                  for b in ((64, 1) if site.startswith("G") else batches))
# kernel vs plain: max|kernel - plain| <= TOL * max(1, max|plain|).  bf16:
# both round the output to bf16 (2^-8 relative) and the plain version also
# rounds the probabilities to bf16; fp32: the kernel sums in another order
# and uses the SFU exponential (~2 ulp).
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# whole generator, fp32 on the card vs fp32 on the CPU (tanh output in
# [-1, 1]): cuDNN and the CPU sum the convolutions in other orders
G_TOL = 1e-4
# whole generator on the card with K7 vs the plain SN: the same cuDNN
# convolutions, only the SN sums in another order (as the JAX test of the
# fused SN holds a whole G, tests/test_pallas_kernels.py)
G_SN_TOL = 1e-5

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


def _build_report(paths: dict) -> str:
    """Kernels, registers and spill stores of each source's libraries,
    from the compiler's ``-Xptxas -v`` reports beside them."""
    per_source = {}
    for (name, _), path in paths.items():
        per_source[name] = per_source.get(name, "") + \
            path.with_suffix(".log").read_text()
    report = []
    for name, logs in per_source.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", logs)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             logs)]
        report.append(f"{name} {len(regs)} kernels, registers max "
                      f"{max(regs)}, spill stores max {max(spills)} bytes")
    return "; ".join(report)


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build(cuda_attention.build_specs()
                         + cuda_spectral.build_specs())
    print(f"phase 1 build: {len(paths)} libraries, one nvcc each, all "
          f"started together: {time.perf_counter() - t0:.1f} s in total; "
          f"{_build_report(paths)}", flush=True)


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
    """K1 on each engine of the dtype (``ENGINES``) against the plain
    version at every site (``FWD_CALLS``), bf16 and fp32, with times of
    each kernel, the plain version and the library calls (SDPA as given,
    and in bf16 ``sdpa_padded``, K1's library column).  Returns the rows
    of the heaviest main-path call (G's 64 map, B=64, bf16) by engine."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    heads = {}
    for site, n, m, d, c, b in FWD_CALLS:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, n, d, device="cuda", generator=gen)
            k = torch.randn(b, m, d, device="cuda", generator=gen)
            v = torch.randn(b, m, c, device="cuda", generator=gen)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            ref = attention_reference(q, k, v)
            lib = F.scaled_dot_product_attention(q, k, v, scale=1.0)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            lib_err = (lib.float() - ref.float()).abs().max().item()
            plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v))[0]
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0))[0]
            bound_ms, bound_by = attention_bound_ms(b, n, m, d, c, dtype)
            name = str(dtype).removeprefix("torch.")
            pad_ms, pad_note = None, ""
            if dtype == torch.bfloat16:
                # SDPA on d = 2 as given runs the math backend; with q, k
                # zero-padded to 8 it takes a backend that does not
                # materialise the logits
                padded = sdpa_padded(q, k, v)
                pad_err = (padded.float() - ref.float()).abs().max().item()
                pad_ms = cuda_time_ms(sdpa_padded, q, k, v)[0]
                pad_note = f"; sdpa_padded ms {pad_ms:.4f} (err {pad_err:.3g})"
            times, device = {}, {}
            for engine in ENGINES[dtype]:
                out = cuda_attention.attention_fused(q, k, v, engine=engine)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = err <= TOL[dtype] * max(1.0, scale)
                ms = cuda_time_ms(cuda_attention.attention_fused, q, k, v,
                                  (), engine)[0]
                times[engine] = ms
                device[engine] = kernel_ms_per_call(
                    cuda_attention.attention_fused, q, k, v, (), engine)
                print(f"phase 2 kernel attention_fwd ({engine}) {site} B={b} "
                      f"N={n} M={m} d={d} c={c} {name}: max_abs_err "
                      f"{err:.3g} max_rel_err {err / scale:.3g} (tol "
                      f"{TOL[dtype]:g} x max(1, max|plain|={scale:.3g})) "
                      f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms "
                      f"{plain_ms:.4f} library_ms {lib_ms:.4f} (sdpa err "
                      f"{lib_err:.3g}){pad_note} bound_ms "
                      f"{bound_ms:.3g} ({bound_by}) on {card}", flush=True)
                require(ok, f"attention_fwd ({engine}) disagrees with the "
                            f"plain version at {site} B={b} {name}")
                if engine not in heads:
                    heads[engine] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": pad_ms,
                        "at": f"{site} B={b} N={n} M={m} d={d} c={c} {name}"}
            if len(times) == 2:
                mma, fma = times["mma"], times["fma"]
                alone = ratio_or_not_measured(device["mma"], device["fma"])
                print(f"phase 2 K1 at {site} B={b} {name}: mma {mma:.4f} "
                      f"ms, fma {fma:.4f} ms, sdpa_padded {pad_ms:.4f} ms: "
                      f"mma/fma {mma / fma:.2f}x, mma/sdpa_padded "
                      f"{mma / pad_ms:.2f}x; kernels alone (profiler) mma "
                      f"{ms_or_not_measured(device['mma'])}, fma "
                      f"{ms_or_not_measured(device['fma'])}: "
                      f"{alone} on {card}",
                      flush=True)
    return heads


def _worst(worst: dict) -> str:
    return ", ".join(f"{key} {x:.3f}" for key, x in worst.items())


def phase_all_widths() -> None:
    """Every (dtype, engine, d, c) instance the libraries hold, against
    the plain version at phase 9's ragged shapes (N, M not multiples of
    the tiles; N under one row tile; a key set past the mma K1's
    whole-staging budget)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, count = {}, 0
    for b, n, m in FLASH_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            for d in cuda_attention.SUPPORTED_D:
                for c in cuda_attention.SUPPORTED_C:
                    q = torch.randn(b, n, d, device="cuda", generator=gen)
                    k = torch.randn(b, m, d, device="cuda", generator=gen)
                    v = torch.randn(b, m, c, device="cuda", generator=gen)
                    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                    ref = attention_reference(q, k, v).float()
                    scale = max(1.0, ref.abs().max().item())
                    for engine in ENGINES[dtype]:
                        out = cuda_attention.attention_fused(
                            q, k, v, engine=engine).float()
                        err = (out - ref).abs().max().item() / scale
                        key = f"{str(dtype).removeprefix('torch.')} {engine}"
                        worst[key] = max(worst.get(key, 0.0),
                                         err / TOL[dtype])
                        count += 1
                        require(err <= TOL[dtype], f"attention_fwd "
                                f"({engine}) d={d} c={c} {dtype} at B={b} "
                                f"N={n} M={m}: {err} > {TOL[dtype]}")
    print(f"phase 2 kernel attention_fwd, all {count} (dtype, engine, d, c, "
          f"shape) instances at (B, N, M) in {FLASH_RAGGED}: worst error by "
          f"dtype and engine {_worst(worst)} of the tolerance", flush=True)


# K2 vs its plain backward, per output: max|kernel - plain| <= BWD_TOL x
# max|plain|.  bf16: both round the outputs to bf16 (2^-9 relative) and
# the plain version also rounds dL, E and g/l to bf16 on the way, as the
# TPU kernel does; fp32: the kernel sums in another order, takes dq in one
# rescaled pass and uses the SFU exponential (~2 ulp)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def attention_bwd_bound_ms(b, n, m, d, c, dtype) -> tuple[float, str]:
    """Least time for one backward call: q, k, v, g read once and dq, dk,
    dv written once over the HBM rate, or the 2·B·N·M·(3d+2c) FLOPs the
    JAX package declares for ``_bwd_call`` over the operand type's peak,
    whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * b * (2 * n * d + 2 * m * d + 2 * m * c + n * c)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * n * m * (3 * d + 2 * c) / PEAK_FLOPS[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def _bwd_inputs(gen, b, n, m, d, c, dtype):
    shapes = ((b, n, d), (b, m, d), (b, m, c), (b, n, c))
    return [torch.randn(s, device="cuda", generator=gen).to(dtype)
            for s in shapes]


def _grad_errors(got, want, tol: float) -> tuple[float, float]:
    """(worst error over the outputs as a share of ``tol`` x max|plain|,
    worst absolute error)."""
    torch.cuda.synchronize()
    share, worst = 0.0, 0.0
    for x, y in zip(got, want, strict=True):
        require(x.dtype == y.dtype and x.shape == y.shape,
                f"kernel output {x.dtype} {tuple(x.shape)} vs plain "
                f"{y.dtype} {tuple(y.shape)}")
        err = (x.float() - y.float()).abs().max().item()
        scale = max(y.float().abs().max().item(), 1e-30)
        share = max(share, err / (tol * scale))
        worst = max(worst, err)
    return share, worst


def _bwd_errors(q, k, v, g, dtype, engine=None) -> tuple[float, float]:
    """(worst error over dq, dk, dv as a share of its tolerance, worst
    absolute error) of K2 on ``engine`` against the plain backward."""
    return _grad_errors(
        cuda_attention.attention_bwd_fused(q, k, v, g, engine=engine),
        attention_bwd_reference(q, k, v, g), BWD_TOL[dtype])


def phase_bwd_kernels(card: str) -> dict:
    """K2 on each engine of the dtype (``ENGINES``) against its plain
    backward at every site of a training step, bf16 and fp32, with times
    beside the plain version's and autograd through SDPA (as given, and
    in bf16 through ``sdpa_padded``, K2's library column).  In bf16 also:
    the mma K2's key blocks against the port's copy of their rule, and two
    calls give the same bits.  Returns the rows of the heaviest main-path
    call (G 64 map, B=64, bf16) by engine."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    heads = {}
    for site, n, m, d, c, batches in TRAIN_SITES:
        for b in batches:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, g = _bwd_inputs(gen, b, n, m, d, c, dtype)
                want = attention_bwd_reference(q, k, v, g)
                plain_ms = cuda_time_ms(lambda: attention_bwd_reference(
                    q, k, v, g))[0]
                qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
                out = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
                    out, (qs, ks, vs), g, retain_graph=True))[0]
                del out
                bound_ms, bound_by = attention_bwd_bound_ms(b, n, m, d, c,
                                                            dtype)
                name = str(dtype).removeprefix("torch.")
                pad_ms, pad_note = None, ""
                if dtype == torch.bfloat16:
                    pad_ms = cuda_time_ms(sdpa_padded(q, k, v, g))[0]
                    pad_note = (f"; autograd through sdpa_padded ms "
                                f"{pad_ms:.4f}")
                    blocks = cuda_attention.bwd_mma_key_blocks(b, m, d, c)
                    rule = k2_key_blocks(b, m, d, c, sms)
                    first = cuda_attention.attention_bwd_fused(
                        q, k, v, g, engine="mma")
                    second = cuda_attention.attention_bwd_fused(
                        q, k, v, g, engine="mma")
                    same = all(torch.equal(x, y)
                               for x, y in zip(first, second))
                    print(f"phase 5 attention_bwd (mma) {site} B={b}: "
                          f"{blocks} key blocks (rule {rule}), dq partials "
                          f"{4 * b * blocks * n * d / 1e6:.2f} MB; two "
                          f"calls bit-identical {same}", flush=True)
                    require(blocks == rule, f"K2 key blocks {blocks}, rule "
                                            f"{rule} at {site} B={b}")
                    require(same, f"two mma K2 calls differ at {site} B={b}")
                    del first, second
                times, device = {}, {}
                for engine in ENGINES[dtype]:
                    share, err = _grad_errors(
                        cuda_attention.attention_bwd_fused(
                            q, k, v, g, engine=engine), want, BWD_TOL[dtype])
                    ms = cuda_time_ms(cuda_attention.attention_bwd_fused,
                                      q, k, v, g, (), engine)[0]
                    times[engine] = ms
                    device[engine] = kernel_ms_per_call(
                        cuda_attention.attention_bwd_fused, q, k, v, g, (),
                        engine)
                    print(f"phase 5 kernel attention_bwd ({engine}) {site} "
                          f"B={b} N={n} M={m} d={d} c={c} {name}: "
                          f"max_abs_err {err:.3g}, worst {share:.3f} of tol "
                          f"{BWD_TOL[dtype]:g} x max|plain| "
                          f"{'ok' if share <= 1 else 'FAIL'}; ms {ms:.4f} "
                          f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                          f"(autograd through sdpa){pad_note} bound_ms "
                          f"{bound_ms:.3g} ({bound_by}) on {card}",
                          flush=True)
                    require(share <= 1, f"attention_bwd ({engine}) disagrees "
                                        f"with the plain backward at {site} "
                                        f"B={b} {name}")
                    if engine not in heads:
                        heads[engine] = {
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": pad_ms,
                            "at": f"{site} B={b} N={n} M={m} d={d} c={c} "
                                  f"{name}"}
                if len(times) == 2:
                    mma, fma = times["mma"], times["fma"]
                    alone = ratio_or_not_measured(device["mma"],
                                                  device["fma"])
                    print(f"phase 5 K2 at {site} B={b} {name}: mma {mma:.4f} "
                          f"ms, fma {fma:.4f} ms, autograd through "
                          f"sdpa_padded {pad_ms:.4f} ms: mma/fma "
                          f"{mma / fma:.2f}x, mma/sdpa_padded "
                          f"{mma / pad_ms:.2f}x; kernels alone (profiler) "
                          f"mma {ms_or_not_measured(device['mma'])}, fma "
                          f"{ms_or_not_measured(device['fma'])}: "
                          f"{alone} on {card}",
                          flush=True)
    return heads


def phase_bwd_all_widths() -> None:
    """Every (dtype, engine, d, c) instance of K2 against the plain
    backward at phase 9's ragged shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst, count = {}, 0
    for b, n, m in FLASH_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            for d in cuda_attention.SUPPORTED_D:
                for c in cuda_attention.SUPPORTED_C:
                    q, k, v, g = _bwd_inputs(gen, b, n, m, d, c, dtype)
                    for engine in ENGINES[dtype]:
                        share, _ = _bwd_errors(q, k, v, g, dtype, engine)
                        key = f"{str(dtype).removeprefix('torch.')} {engine}"
                        worst[key] = max(worst.get(key, 0.0), share)
                        count += 1
                        require(share <= 1, f"attention_bwd ({engine}) d={d} "
                                f"c={c} {dtype} at B={b} N={n} M={m}: "
                                f"{share:.3f} of its tolerance")
    print(f"phase 5 kernel attention_bwd, all {count} (dtype, engine, d, c, "
          f"shape) instances at (B, N, M) in {FLASH_RAGGED}: worst error by "
          f"dtype and engine {_worst(worst)} of the tolerance", flush=True)


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


def phase_serve(gen32, card: str) -> dict:
    """Serve the church64 G over HTTP; returns the raw bytes served by
    (n, seed)."""
    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    config = church64_config("bfloat16")
    weights = export_generator_npz(gen32, str(smoke_dir / "church64_g.npz"),
                                   config)

    _zero_counts()                   # the main path starts here
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
    counts = _counts()               # the main path ends here
    want = _launches(K1mma=2 * forwards)
    print(f"phase 4 serve: launches {counts} for {forwards} bf16 generator "
          f"forwards (2 attention sites each, the tensor-core K1; expected "
          f"{want})", flush=True)
    require(counts == want, f"serving launches {counts}, expected {want}")
    return raw


# one fp32 step of the full-width church64 G and D, card vs CPU: every
# gradient norm within STEP_RTOL of the CPU's (cuDNN and the CPU sum the
# convolutions in other orders, K2 takes dq in one rescaled pass; errors
# compound through G, D and the loss), or within STEP_ATOL where a norm is
# ~0 analytically (phi's bias: the softmax ignores a per-query constant);
# the losses, means of O(1) scores (G's near 0), within STEP_LOSS_ATOL.
# G's loss and gradients are held so only in a step with D's learning rate
# 0: Adam with beta1 = 0 moves every parameter by +-lr on its first update,
# so an element whose gradient is ~0 lands 2 lr_d apart on the two
# devices, and G's gradient, taken through the updated D, then differed by
# up to 0.5 % (measured).  In the step at the config's learning rates the
# parameters, buffers and EMA after the step are held within
# 3 lr_d (2 lr of sign noise, lr_g < lr_d) with under
# 1 % of their elements beyond 1e-5, as the CPU parity test against JAX.
# The elements beyond 1e-5 are where G's gradient lies within a few Adam
# eps (1e-7) of 0, so their moves follow the card's rounding: cuDNN's
# default weight-gradient algorithms sum with atomics, and on an H100
# 80GB HBM3 at 700 W runs of this phase read 31, 2179, 2183 and 37337
# (1.4 %) elements beyond 1e-5.  The card's steps here take cuDNN's
# deterministic algorithms (4259 in each run, 0.16 %), so the check holds
# the port, not the order of cuDNN's atomic adds.
STEP_BATCH = 16
STEP_RTOL = 1e-3
STEP_ATOL = 1e-6
STEP_LOSS_ATOL = 1e-4
STEP_KEYS = ("G_grad_norm", "D_grad_norm")
# synthetic 64 px records of the entry-point run: 32 steps an epoch at
# batch 64, 4 calls of steps_per_call 8
SMOKE_RECORDS = 2048


def _church64_nets(config, seed):
    """Seeded full-width G and D (CPU) with every attention sigma
    nonzero, so the attention weights get a gradient."""
    gen = get_generator(config, rng=torch.Generator().manual_seed(seed))
    disc = get_discriminator(config,
                             rng=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        for i, mod in enumerate(m for net in (gen, disc)
                                for m in net.modules()
                                if isinstance(m, SelfAttention)):
            mod.sigma.fill_(0.5 + 0.25 * i)
    return gen, disc


@contextlib.contextmanager
def _deterministic_cudnn():
    """While open, cuDNN takes only its deterministic algorithms (its
    default weight-gradient sums use atomics, another order each run)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _one_step(config, gen, disc, device, images, labels, latents):
    gen, disc = copy.deepcopy(gen).to(device), copy.deepcopy(disc).to(device)
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        config, gen.parameters(), disc.parameters(), steps_per_epoch=1)
    state = TrainState(gen, disc, opt_g, opt_d, 0,
                       {n: p.detach().clone()
                        for n, p in gen.named_parameters()})
    step = build_train_step(config, sched_g, sched_d, gen, disc)
    moved = [{"flip": None, "g": tuple(t.to(device) for t in lat["g"]),
              "d": [tuple(t.to(device) for t in zl) for zl in lat["d"]]}
             for lat in latents]
    with _deterministic_cudnn():
        _zero_counts()
        metrics = step(state, images.to(device), labels.to(device), moved)
        launches = _counts()
    after = {f"G/{k}": v for k, v in gen.state_dict().items()}
    after.update({f"D/{k}": v for k, v in disc.state_dict().items()})
    after.update({f"EMA/{k}": v for k, v in state.ema.items()})
    return ({k: v.detach().cpu() for k, v in metrics.items()}, step,
            {k: v.detach().cpu() for k, v in after.items()}, launches)


def _state_errors(got: dict, want: dict, atol: float) -> tuple:
    """(largest |card - cpu|, elements beyond 1e-5, elements, names beyond
    ``atol``) over two states after a step."""
    require(got.keys() == want.keys(), "the states hold other tensors")
    worst, off, total, bad = 0.0, 0, 0, []
    for name, y in want.items():
        err = (got[name].double() - y.double()).abs()
        if err.numel() and err.max().item() > atol:
            bad.append(f"{name} {err.max().item():.3g}")
        worst = max([worst] + ([err.max().item()] if err.numel() else []))
        off += int((err > 1e-5).sum())
        total += y.numel()
    return worst, off, total, bad


def phase_train_step(card: str) -> dict:
    """One fp32 training step on the card against the CPU, from the same
    seeded nets, images and latents: with D frozen, then at the config's
    learning rates.  Returns the second step's launches by kernel (the
    CUDA-core K1 and K2: fp32's engine)."""
    full = church64_config("float32")
    config = dict(full, lr_d=0.0)
    gen, disc = _church64_nets(config, SEED + 10)
    rs = np.random.RandomState(SEED)
    b = STEP_BATCH
    images = torch.from_numpy(rs.randint(0, 256, (1, b, 64, 64, 3))
                              .astype(np.uint8))
    labels = torch.zeros(1, b, dtype=torch.int32)
    rng = torch.Generator().manual_seed(SEED + 11)

    def draw():
        return (torch.randn(b, config["z_dim"], generator=rng),
                torch.zeros(b, dtype=torch.long))

    latents = [{"flip": None, "d": [draw()], "g": draw()}]
    want, step, _, _ = _one_step(config, gen, disc, "cpu", images, labels,
                                 latents)
    got, _, _, launches = _one_step(config, gen, disc, "cuda", images,
                                    labels, latents)

    def close(x, y):
        return abs(x - y) <= STEP_RTOL * abs(y) + STEP_ATOL

    loss_err = max(abs(float(got[k]) - float(want[k]))
                   for k in ("G_loss", "D_loss"))
    worst = max(abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                for k in STEP_KEYS)
    bad = [k for k in STEP_KEYS if not close(float(got[k]), float(want[k]))]
    if loss_err > STEP_LOSS_ATOL:
        bad.append(f"losses {loss_err:.3g} apart")
    attn = {}
    for key, names in (("G_grad_norms", step.g_names),
                       ("D_grad_norms", step.d_names)):
        for name, x, y in zip(names, got[key].tolist(), want[key].tolist()):
            if not close(x, y):
                bad.append(f"{key} {name}: card {x:.6g} cpu {y:.6g}")
            if re.fullmatch(r"attn\d+\.(theta|phi|g)\.w", name):
                attn[name] = x
    print(f"phase 6 train step fp32 B={b} card vs cpu: G_loss "
          f"{float(got['G_loss']):.6f} ({float(want['G_loss']):.6f}) D_loss "
          f"{float(got['D_loss']):.6f} ({float(want['D_loss']):.6f}), "
          f"max abs err {loss_err:.3g} (tol {STEP_LOSS_ATOL:g}); worst rel "
          f"err of the global gradient norms {worst:.3g}; "
          f"{len(step.g_names) + len(step.d_names)} per-variable gradient "
          f"norms within rtol {STEP_RTOL:g} (+{STEP_ATOL:g}): "
          f"{'all' if not bad else 'NOT ' + str(bad[:4])}; attention "
          f"theta/phi/g gradient norms min {min(attn.values()):.3g} over "
          f"{len(attn)} weights; launches K1 {launches['K1']} K2 "
          f"{launches['K2']} "
          f"on {card}", flush=True)
    require(not bad, f"training step on the card disagrees with the CPU: "
                     f"{bad[:8]}")
    require(len(attn) == 12 and min(attn.values()) > 1e-6,
            f"attention weights without a gradient: {attn}")
    require(launches == _launches(K1=8, K2=6), f"one fp32 training step "
            f"launched {launches}, expected K1 8, K2 6 (the CUDA cores)")

    # the config's learning rates: what comes before D's update is held
    # as above, the state after the step within 3 lr_d
    want, _, want_state, _ = _one_step(full, gen, disc, "cpu", images,
                                       labels, latents)
    got, _, got_state, launches = _one_step(full, gen, disc, "cuda", images,
                                            labels, latents)
    atol = 3 * full["lr_d"]
    bad = [] if close(float(got["D_grad_norm"]), float(want["D_grad_norm"])) \
        else ["D_grad_norm"]
    bad += [f"D_grad_norms {name}"
            for name, x, y in zip(step.d_names, got["D_grad_norms"].tolist(),
                                  want["D_grad_norms"].tolist())
            if not close(x, y)]
    loss_err = abs(float(got["D_loss"]) - float(want["D_loss"]))
    if loss_err > STEP_LOSS_ATOL:
        bad.append(f"D_loss {loss_err:.3g} apart")
    worst, off, total, far = _state_errors(got_state, want_state, atol)
    print(f"phase 6 train step fp32 B={b} at lr_g {full['lr_g']:g} lr_d "
          f"{full['lr_d']:g}, card vs cpu: D_loss {float(got['D_loss']):.6f} "
          f"({float(want['D_loss']):.6f}); D_grad_norm and "
          f"{len(step.d_names)} per-variable D gradient norms within rtol "
          f"{STEP_RTOL:g} (+{STEP_ATOL:g}): "
          f"{'all' if not bad else 'NOT ' + str(bad[:4])}; G, D and EMA "
          f"state after the step ({len(got_state)} tensors, {total} "
          f"elements): max abs err {worst:.3g} (tol {atol:g}), {off} "
          f"elements beyond 1e-5 (tol 1 %); launches K1 {launches['K1']} K2 "
          f"{launches['K2']} on {card}", flush=True)
    require(not bad, f"D's step on the card disagrees with the CPU: "
                     f"{bad[:8]}")
    require(not far and off <= 0.01 * total,
            f"the state after a step on the card disagrees with the CPU: "
            f"{far[:8]}, {off} of {total} elements beyond 1e-5")
    require(launches == _launches(K1=8, K2=6), f"one fp32 training step "
            f"launched {launches}, expected K1 8, K2 6 (the CUDA cores)")
    return launches


def _run_cli(config_file: Path, card: str, label: str) -> tuple:
    """``python -m sagan_tpu_torch.main --config_path config_file`` in
    this process, its output shown and kept (``label`` starts each line:
    "<phase> <run>").  Returns (trainer, output, launches by kernel,
    sample-grid forwards, epochs), the launch counts zeroed just before
    and read just after."""
    grids = []
    sample = Trainer.sample_images

    def counted(self):
        grids.append(1)
        return sample(self)

    Trainer.sample_images = counted
    out = io.StringIO()
    try:
        _zero_counts()
        with contextlib.redirect_stdout(out):
            trainer = train_cli.main(["--config_path", str(config_file),
                                      "--device", "cuda"])
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        Trainer.sample_images = sample
    text = out.getvalue()
    epochs = re.findall(r"^epoch (\d+): G_loss=(\S+) D_loss=(\S+) .*"
                        r"\(([\d.]+) imgs/s, ([\d.]+) ms/step\)$", text,
                        re.MULTILINE)
    for line in text.splitlines():
        if line.startswith(("epoch ", "Restored", "Initializing",
                            "total steps", "resuming")):
            print(f"phase {label}: {line}", flush=True)
    for epoch, g_loss, d_loss, imgs_s, ms_step in epochs:
        print(f"phase {label} epoch {epoch}: {imgs_s} imgs/s, {ms_step} "
              f"ms/step (host clock over the epoch, loader included) on "
              f"{card}", flush=True)
        require(math.isfinite(float(g_loss)) and math.isfinite(float(d_loss)),
                f"epoch {epoch} losses are not finite: {g_loss} {d_loss}")
    return trainer, text, counts, len(grids), len(epochs)


def phase_train_cli(card: str) -> tuple[int, int]:
    """Train the church64 config through the entry point, restart it, and
    sample its checkpoint.  Returns the (K1, K2) launches of the first
    run."""
    smoke = ROOT / "build" / "smoke"
    data = smoke / "church64_synthetic"
    for sub in ("ckpt", "logs", "images", "samples"):
        shutil.rmtree(smoke / sub, ignore_errors=True)
    if not (data / "metadata.pickle").exists():
        t0 = time.perf_counter()
        make_synthetic_dataset(str(data), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED)
        print(f"phase 7 data: {SMOKE_RECORDS} synthetic 64 px records in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    files = {}
    for epochs in (2, 3):
        files[epochs] = smoke / f"church64_smoke_e{epochs}.py"
        files[epochs].write_text(
            f"import runpy\n"
            f"config = dict(runpy.run_path({str(CONFIG)!r})['config'])\n"
            f"config.update(data_path={str(data)!r}, epoch={epochs}, "
            f"ckpt_dir={str(smoke / 'ckpt')!r}, "
            f"log_dir={str(smoke / 'logs')!r}, "
            f"img_dir={str(smoke / 'images')!r}, print_variables=False)\n")

    results, first_step = {}, 0
    for label, epochs in (("run", 2), ("restart", 3)):
        trainer, text, counts, grids, n_epochs = _run_cli(
            files[epochs], card, f"7 {label}")
        k1, k2 = counts["K1mma"], counts["K2mma"]
        steps = trainer.global_step() - first_step
        want = _launches(K1mma=8 * steps + 2 * grids, K2mma=6 * steps)
        print(f"phase 7 {label}: {steps} steps, {grids} sample-grid "
              f"forwards; launches {counts} (expected {want}: the "
              f"tensor-core K1 and K2, none on the CUDA cores)", flush=True)
        require(n_epochs == epochs - first_step // trainer.steps_per_epoch
                and trainer.global_step() == epochs * trainer.steps_per_epoch,
                f"{label}: {n_epochs} epochs, step {trainer.global_step()}")
        require(counts == want, f"{label}: launches {counts} for {steps} "
                                f"steps and {grids} grids, expected {want}")
        results[label] = (k1, k2)
        if first_step:
            require(f"Restored from checkpoint at step {first_step}" in text,
                    "the restart did not restore the checkpoint")
        else:
            require("Initializing from scratch." in text,
                    "the first run did not start from scratch")
        first_step = trainer.global_step()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        written = generate.main([
            "--config_path", str(files[3]), "--device", "cuda", "--num",
            "16", "--format", "npz", "--out", str(smoke / "samples")])
        gen = generate.restore_generator(
            resolve_config(load_config_file(str(files[3]))), "cuda")
    with torch.inference_mode():
        z = torch.randn(16, 128, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
        x = gen(z, torch.zeros(16, dtype=torch.long, device="cuda")).float()
    imgs = np.load(written[0])["images"]
    ema = "(EMA generator)" in out.getvalue()
    print(f"phase 7 generate from the checkpoint: {out.getvalue().strip()}; "
          f"{imgs.shape} {imgs.dtype} std {imgs.std():.2f}; float images "
          f"finite {bool(torch.isfinite(x).all())}", flush=True)
    require(ema and imgs.shape == (16, 64, 64, 3) and imgs.std() > 0
            and bool(torch.isfinite(x).all()) and x.abs().max() <= 1,
            "generate did not restore finite EMA images")
    _check_generate_step(files[3], smoke)
    return results["run"]


def _check_generate_step(config_file: Path, smoke: Path) -> None:
    """``generate --step <first saved step>`` gives the bytes of sampling
    that checkpoint loaded directly (``restore_step``, its EMA G), and a
    step that was not saved raises ``KeyError`` naming the saved ones."""
    mgr = CheckpointManager(str(smoke / "ckpt"))
    saved = mgr.all_steps()
    first = saved[0]
    argv = ["--config_path", str(config_file), "--device", "cuda", "--num",
            "16", "--format", "npz", "--out", str(smoke / "samples_step")]
    with contextlib.redirect_stdout(io.StringIO()):
        written = generate.main(argv + ["--step", str(first)])
    ckpt = mgr.restore_step(first)
    config = resolve_config(load_config_file(str(config_file)))
    gen = get_generator({**config, **ckpt["meta"]})
    gen.load_state_dict({**ckpt["gen"], **ckpt["ema"]})
    want = generate.sample_images(gen.to("cuda"), num=16, batch=64,
                                  z_dim=config["z_dim"], num_classes=1)
    same = np.array_equal(np.load(written[0])["images"], want)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            generate.main(argv + ["--step", str(first + 1)])
        missing = "no error"
    except KeyError as err:
        missing = str(err)
    print(f"phase 7 generate --step {first} (saved steps {saved}): the "
          f"checkpoint's bytes {'exactly' if same else 'NOT'}; --step "
          f"{first + 1} raises KeyError {missing}", flush=True)
    require(same and len(saved) == 2 and str(saved) in missing,
            "generate --step did not sample the pinned checkpoint, or a "
            "missing step did not raise naming the saved ones")


CHURCH512 = ROOT / "example_configs" / "church512_attn.py"
# church512's G site, the flash path's (B, N, M, d, c) at the config's B
FLASH_SITE = (4, 512 * 512, 256 * 256, 2, 8)
# phase 8's batches there: the config's, and that of phase 13's step,
# whose backward takes K6 in bf16 and K4 + K5 in fp32
FLASH_BATCHES = (4, 8)
# church256 G's 256-map site (bench.py CHURCH256), where phase 8 also
# times both engines of K3 and K6
FLASH_256 = (16, 256 * 256, 128 * 128, 2, 8)
# the flash kernels vs their plain versions.  K3's o per query row: the
# row's max|kernel - plain| <= TOL x the row's max|plain| (ROW_FLOOR
# where that is smaller).  A scale of the whole tensor would not do: at the
# 512 map a typical row averages v over ~10^4 keys (|o| ~ 0.01), while a
# few rows with large |q| attend to one key (|o| ~ 2).  ROW_FLOOR is the
# spread of a row that weighs v's unit normals evenly over 65,536 keys.
# lse, fp32 in both dtypes from the same logits: LSE_TOL x max(1,
# max|plain|), the kernel sums exp in another order with the SFU
# exponential.  K4-K6, per output, BWD_TOL x max|plain| as K2: bf16,
# both round the outputs to bf16, and the plain version also rounds dL and
# P to bf16 on the way, as the TPU kernels do; fp32, each sums in another
# order (in tiles and blocks of up to 1,024 keys; on the rows where they
# differ most, each dq is within 4e-6 of max|dq| of its float64 value).
ROW_FLOOR = 1 / 256
LSE_TOL = 1e-5
# fp32 dq vs float64 on the rows where the kernels and the plain version
# differ most
F64_ROWS = 64
# synthetic 512 px records of the church512 run: 16 steps an epoch at
# B=4, 4 calls of steps_per_call 4
SMOKE512_RECORDS = 64
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION]


def _flash_bound_ms(kind, b, n, m, d, c, dtype) -> tuple[float, str]:
    """Least time of one flash call: the bytes its function must move
    (each input read once, each output written once; lse is fp32) over the
    HBM rate, or the FLOPs the JAX package declares for its kernel over
    the operand type's peak, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    rows = {"fwd": (n * d + m * d + m * c + n * c, 4 * n),
            "dq": (n * d + m * d + m * c + 2 * n * c + n * d, 4 * n),
            "dkv": (n * d + 2 * m * d + 2 * m * c + 2 * n * c, 4 * n),
            "dqkv": (2 * n * d + 2 * m * d + 2 * m * c + 2 * n * c, 4 * n)}
    flops = {"fwd": d + c, "dq": 2 * d + c, "dkv": 2 * d + 2 * c,
             "dqkv": 3 * d + 2 * c}
    elems, lse_bytes = rows[kind]
    bytes_ms = b * (size * elems + lse_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * n * m * flops[kind] / PEAK_FLOPS[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def _sdpa_flash(q, k, v, g, ref_o) -> dict:
    """``scaled_dot_product_attention(scale=1.0)`` on a backend that does
    not materialise the [B, N, M] logits, on [B, 1, L, E] views: first
    as given, then with q and k zero-padded to 8 wide (the logits do not
    change) where no such backend takes d.  Returns its forward and
    backward (autograd) ms, its error against the plain o and a note, or
    Nones and why no backend took the call."""
    q4, k4, v4, g4 = (t.unsqueeze(1) for t in (q, k, v, g))
    why = []
    for pad in (0, max(0, 8 - q.shape[2])):
        if why and not pad:
            break
        qp, kp = (F.pad(t, (0, pad)) if pad else t for t in (q4, k4))
        qp, kp, vp = (t.detach().requires_grad_() for t in (qp, kp, v4))
        with sdpa_kernel(SDPA_BACKENDS), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out = F.scaled_dot_product_attention(qp, kp, vp, scale=1.0)
            except RuntimeError:
                # each backend warns why it declined: keep the reasons
                reasons = {re.sub(r"\s*\(Triggered internally.*", "", line)
                           .strip()[:100]
                           for w in caught
                           for line in str(w.message).splitlines()
                           if re.search(r"requires|Expected|should be",
                                        line)}
                why.append(f"{'padded' if pad else 'as given'}: "
                           + " / ".join(sorted(reasons)))
                continue
            fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qp, kp, vp, scale=1.0), iters=5, warmup=1)[0]
            bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
                out, (qp, kp, vp), g4, retain_graph=True), iters=3,
                warmup=1)[0]
        err = (out.squeeze(1).float() - ref_o.float()).abs().max().item()
        note = (f"q, k zero-padded {q.shape[2]} -> {q.shape[2] + pad}"
                if pad else "as given")
        return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "err": err,
                "note": "; ".join(why + [note])}
    return {"fwd_ms": None, "bwd_ms": None, "err": None,
            "note": "no backend: " + "; ".join(why)}


def _o_errors(o, ref_o, dtype) -> tuple[float, float, float]:
    """K3's o against the plain o: (worst row's error as a share of its
    tolerance, worst absolute error, the whole tensor's max|plain|)."""
    torch.cuda.synchronize()
    want = ref_o.float()
    err = (o.float() - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1).clamp_min(ROW_FLOOR)
    return ((err / (TOL[dtype] * scale)).max().item(), err.max().item(),
            want.abs().max().item())


def _dq_f64(q, k, v, o, lse, g, dqs: dict) -> dict:
    """Each fp32 dq of ``dqs`` ({name: [B, N, d]}) against float64 on the
    ``F64_ROWS`` rows where they differ most: p = exp(q.k - lse),
    delta = g.o and dq = sum_j p (g.v_j - delta) k_j from the same fp32
    inputs, all in float64.  Returns {name: max abs error}."""
    b, n, _ = q.shape
    stack = torch.stack([x.float() for x in dqs.values()])
    spread = (stack.amax(0) - stack.amin(0)).amax(-1).flatten()
    idx = spread.topk(F64_ROWS).indices
    bi, ni = idx // n, idx % n
    kb, vb = k[bi].double(), v[bi].double()                # [R, M, *]
    s = torch.einsum("rd,rmd->rm", q[bi, ni].double(), kb)
    p = torch.exp(s - lse[bi, ni].double())
    gr = g[bi, ni].double()
    delta = (gr * o[bi, ni].double()).sum(-1, keepdim=True)
    dl = p * (torch.einsum("rc,rmc->rm", gr, vb) - delta)
    want = torch.einsum("rm,rmd->rd", dl, kb)
    return {name: (x[bi, ni].double() - want).abs().max().item()
            for name, x in dqs.items()}


def _row(err, ms, plain_ms, bound, lib_ms) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms}


def phase_flash_kernels(card: str) -> dict:
    """K3-K6 against their plain versions at the church512 512-map site,
    bf16 and fp32, at B=4 and 8, each on the dtype's engine (the tensor
    cores in bf16) and in bf16 also on the CUDA cores (``engine="fma"``):
    K6 against K4 + K5 on the same (o, lse), the tensor-core K5's dk and dv
    against K6's bit for bit, two calls of the tensor-core K4 + K5 bit for
    bit, and in fp32 each dq against float64 on its worst rows; times at
    both batches beside padded SDPA, the plain versions and the bounds.
    Then K3 and K6 timed at church256's 256 map (``_flash_256``).  Returns
    {B: {kernel: its bf16 row}}."""
    _, n, m, d, c = FLASH_SITE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    heads = {}
    for b in FLASH_BATCHES:
        chunk = plain_chunk(b, n, m)
        heads[b] = {}
        site = f"G 512map B={b} N={n} M={m} d={d} c={c}"
        routes = []
        for engine, itemsize in (("mma", 2), ("fma", 4)):
            part = cuda_attention.dq_partial_shape(b, n, m, d, c,
                                                   engine=engine)
            fused = flash_bwd_fused(b, n, m, d, c, itemsize)
            keys = cuda_attention.keys_per_block(d, c, engine=engine)
            routes.append(f"{engine} {keys} keys a block, {part} fp32, "
                          f"{4 * math.prod(part) / 1e6:.1f} MB, route "
                          f"{'K6' if fused else 'K4 + K5'}")
        print(f"phase 8 K6 dq partials at {site}: " + "; ".join(routes)
              + f"; plain versions in chunks of {chunk} query rows",
              flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            bf16 = dtype == torch.bfloat16
            # the dtype's engine, and the CUDA-core one beside it in bf16
            engines = ("mma", "fma") if bf16 else ("fma",)
            q, k, v, g = _bwd_inputs(gen, b, n, m, d, c, dtype)
            ref_o, ref_lse = attention_flash_reference(q, k, v, chunk)
            plain_ms = cuda_time_ms(lambda: attention_flash_reference(
                q, k, v, chunk), iters=1, warmup=0)[0]
            lib = _sdpa_flash(q, k, v, g, ref_o)
            bound = _flash_bound_ms("fwd", b, n, m, d, c, dtype)
            for engine in engines:
                o, lse = cuda_attention.attention_flash_fwd(q, k, v,
                                                            engine=engine)
                share, err, o_max = _o_errors(o, ref_o, dtype)
                lse_scale = max(1.0, ref_lse.abs().max().item())
                lse_err = (lse - ref_lse).abs().max().item()
                ok = share <= 1 and lse_err <= LSE_TOL * lse_scale
                ms = cuda_time_ms(lambda: cuda_attention.attention_flash_fwd(
                    q, k, v, engine=engine), iters=5, warmup=1)[0]
                print(f"phase 8 kernel attention_flash_fwd (K3, {engine}) "
                      f"{site} {name}: o max_abs_err {err:.3g} (max|plain| "
                      f"{o_max:.3g}), worst row {share:.3f} of tol "
                      f"{TOL[dtype]:g} x max(row max|plain|, "
                      f"{ROW_FLOOR:g}); lse max_abs_err {lse_err:.3g} (tol "
                      f"{LSE_TOL:g} x max(1, {lse_scale:.3g})) "
                      f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain_ms "
                      f"{plain_ms:.4f} library_ms {lib['fwd_ms']} (sdpa "
                      f"{lib['note']}; err {lib['err']}) bound_ms "
                      f"{bound[0]:.4g} ({bound[1]}) on {card}", flush=True)
                if bf16:
                    heads[b]["fwd" if engine == "mma" else "fwd_fma"] = \
                        _row(err, ms, plain_ms, bound, lib["fwd_ms"])
                require(ok, f"attention_flash_fwd ({engine}) disagrees with "
                            f"the plain version at {site} {name}")
                if engine == engines[0]:
                    keep = o, lse       # the backward's (o, lse)
            del ref_o, ref_lse
            o, lse = keep

            want = attention_flash_bwd_reference(q, k, v, o, lse, g, chunk)
            tol = BWD_TOL[dtype]
            plain_ms = cuda_time_ms(lambda: attention_flash_bwd_reference(
                q, k, v, o, lse, g, chunk), iters=1, warmup=0)[0]
            args = (q, k, v, o, lse, g)
            got = {}
            for engine in engines:
                # the dtype's engine unmarked, the CUDA-core one beside it
                tag = "" if engine == engines[0] else "_fma"
                calls = {
                    "dq": (lambda e=engine: (cuda_attention.attention_flash_dq(
                        *args, engine=e),), want[:1]),
                    "dkv": (lambda e=engine: cuda_attention.attention_flash_dkv(
                        *args, engine=e), want[1:]),
                    "dqkv": (lambda e=engine:
                             cuda_attention.attention_flash_dqkv(
                                 *args, engine=e), want)}
                times = {}
                for kind, (fn, ref) in calls.items():
                    got[kind + tag] = fn()
                    share, err = _grad_errors(got[kind + tag], ref, tol)
                    ms = times[kind] = cuda_time_ms(fn, iters=3, warmup=1)[0]
                    bound = _flash_bound_ms(kind, b, n, m, d, c, dtype)
                    lib_ms = lib["bwd_ms"] if kind == "dqkv" else None
                    print(f"phase 8 kernel attention_flash_{kind} ({engine}) "
                          f"{site} {name}: max_abs_err {err:.3g}, worst "
                          f"{share:.3f} of tol {tol:g} x max|plain| "
                          f"{'ok' if share <= 1 else 'FAIL'}; ms {ms:.4f} "
                          f"plain_ms {plain_ms:.4f} (the plain backward "
                          f"computes all three) library_ms {lib_ms} ("
                          + ("autograd through the sdpa call above"
                             if lib_ms else "no PyTorch call computes this "
                                            "part alone")
                          + f") bound_ms {bound[0]:.4g} ({bound[1]}) on "
                          f"{card}", flush=True)
                    if bf16:
                        heads[b][kind + tag] = _row(err, ms, plain_ms, bound,
                                                    lib_ms)
                    require(share <= 1, f"attention_flash_{kind} ({engine}) "
                                        f"disagrees with the plain backward "
                                        f"at {site} {name}")
                pair = functools.partial(cuda_attention.attention_flash_dq_dkv,
                                         *args, engine=engine)
                pair_ms = cuda_time_ms(pair, iters=3, warmup=1)[0]
                split = got["dq" + tag] + got["dkv" + tag]
                share, err = _grad_errors(got["dqkv" + tag], split, tol)
                same = all(torch.equal(x, y) for x, y in
                           zip(got["dqkv" + tag][1:], got["dkv" + tag]))
                again = all(torch.equal(x, y) for x, y in zip(pair(), split))
                print(f"phase 8 K4 + K5 ({engine}) at {site} {name}: the pair "
                      f"(one delta pass on mma) ms {pair_ms:.4f}, K6 "
                      f"{times['dqkv']:.4f}, autograd through sdpa "
                      f"{lib['bwd_ms']}; K6 vs K4 + "
                      f"K5 on the same (o, lse) max_abs_err {err:.3g}, worst "
                      f"{share:.3f} of tol {tol:g} x max|K4 + K5|; K5's dk, "
                      f"dv bitwise equal to K6's {same}; a second pair "
                      f"bitwise equal {again} on {card}", flush=True)
                if bf16:
                    heads[b]["pair" + tag] = pair_ms
                require(share <= 1, f"K6 ({engine}) disagrees with K4 + K5 "
                                    f"at {site} {name}")
                require(engine == "fma" or (same and again),
                        f"tensor-core K4 + K5 at {site}: dk, dv equal to "
                        f"K6's {same}, two calls equal {again}")
            if dtype == torch.float32:
                scale = want[0].abs().max().item()
                errs = _dq_f64(q, k, v, o, lse, g, {
                    "K4": got["dq"][0], "K6": got["dqkv"][0],
                    "plain": want[0]})
                print(f"phase 8 dq vs float64 on the {F64_ROWS} rows where "
                      f"K4, K6 and the plain dq differ most, {site} fp32 "
                      f"(max|plain dq| {scale:.3g}): " + "; ".join(
                          f"{key} {x:.3g} ({x / scale:.2g} of max|dq|)"
                          for key, x in errs.items()), flush=True)
                require(all(x <= tol * scale for x in errs.values()),
                        f"a dq is off its float64 value: {errs}")
            del want, got, keep
    _flash_256(card)
    return heads


def _flash_256(card: str) -> None:
    """K3 and K6 on both engines at church256 G's 256 map, B=16, bf16:
    times beside padded SDPA (forward, and backward through autograd)
    and the bounds; each held against the plain versions on the study
    check rows (``tools._study.held``: K3's o, K6's dq), K6's dk and dv
    against K5's at ``BWD_TOL``."""
    b, n, m, d, c = FLASH_256
    site = f"church256 G 256map B={b} N={n} M={m} d={d} c={c} bfloat16"
    q, k, v, g = _bwd_inputs(torch.Generator(device="cuda").manual_seed(
        SEED + 23), b, n, m, d, c, torch.bfloat16)
    o, lse = cuda_attention.attention_flash_fwd(q, k, v)
    args = (q, k, v, o, lse, g)
    dk5, dv5 = cuda_attention.attention_flash_dkv(*args)
    lib = {"fwd": cuda_time_ms(sdpa_padded, q, k, v, iters=5, warmup=1)[0],
           "dqkv": cuda_time_ms(sdpa_padded(q, k, v, g), iters=3,
                                warmup=1)[0]}
    for kind in ("fwd", "dqkv"):
        bound = _flash_bound_ms(kind, b, n, m, d, c, torch.bfloat16)
        for engine in ("mma", "fma"):
            if kind == "fwd":
                fn = functools.partial(cuda_attention.attention_flash_fwd,
                                       q, k, v, engine=engine)
                out = fn()[0]
                checks = [held(out, lambda q, k, v: attention_flash_reference(
                    q, k, v)[0], (q,), (k, v), TOL[torch.bfloat16])]
            else:
                fn = functools.partial(cuda_attention.attention_flash_dqkv,
                                       *args, engine=engine)
                dq, dk, dv = fn()
                checks = [held(dq, lambda q, o, lse, g, k, v:
                               attention_flash_bwd_reference(
                                   q, k, v, o, lse, g)[0], (q, o, lse, g),
                               (k, v), BWD_TOL[torch.bfloat16]),
                          max_delta(dk, dk5, BWD_TOL[torch.bfloat16]),
                          max_delta(dv, dv5, BWD_TOL[torch.bfloat16])]
            ms = cuda_time_ms(fn, iters=3, warmup=1)[0]
            ok = all(x["ok"] for x in checks)
            print(f"phase 8 kernel attention_flash_{kind} ({engine}) at "
                  f"{site}: ms {ms:.4f} library_ms {lib[kind]:.4f} (sdpa "
                  f"padded{', autograd' if kind == 'dqkv' else ''}) "
                  f"bound_ms {bound[0]:.4g} ({bound[1]}); max_abs_err "
                  + ", ".join(f"{x['max_abs_err']:.3g} (limit "
                              f"{x['limit']:.3g})" for x in checks)
                  + f" {'ok' if ok else 'FAIL'} on {card}", flush=True)
            require(ok, f"attention_flash_{kind} ({engine}) disagrees at "
                        f"{site}: {checks}")


def _flash_errors(q, k, v, g, dtype, engine=None) -> float:
    """Worst error of K3-K6 (on ``engine``, by default the dtype's; K4 and
    K5 as the two-kernel backward runs them) against the plain versions,
    and of K6 against K4 + K5, as a share of each tolerance; on the
    tensor cores K5's dk and dv must equal K6's bit for bit."""
    o, lse = cuda_attention.attention_flash_fwd(q, k, v, engine=engine)
    ref_o, ref_lse = attention_flash_reference(q, k, v)
    share = max(_o_errors(o, ref_o, dtype)[0],
                (lse - ref_lse).abs().max().item()
                / (LSE_TOL * max(1.0, ref_lse.abs().max().item())))
    tol = BWD_TOL[dtype]
    want = attention_flash_bwd_reference(q, k, v, o, lse, g)
    dq, dk, dv = cuda_attention.attention_flash_dq_dkv(q, k, v, o, lse, g,
                                                       engine=engine)
    fused = cuda_attention.attention_flash_dqkv(q, k, v, o, lse, g,
                                                engine=engine)
    if engine == "mma" or (engine is None and dtype == torch.bfloat16):
        require(torch.equal(dk, fused[1]) and torch.equal(dv, fused[2]),
                f"tensor-core K5's dk, dv differ from K6's at {q.shape} "
                f"{k.shape} {v.shape}")
    for got, ref in (((dq, dk, dv), want), (fused, want),
                     (fused, (dq, dk, dv))):
        share = max(share, _grad_errors(got, ref, tol)[0])
    return share


# phase 9's ragged shapes (B, N, M): N, M off every tile, M under one
# key tile of K3 (64) with N under one m16 row tile, and M past the key
# block of K5 and K6 at every width
FLASH_RAGGED = ((3, 100, 37), (2, 9, 70), (2, 300, 2100))


# phase 9's wide grids (B, N, M): 133 blocks or more at every (d, c)
# (more than the H100's 132 SMs), and a ragged key tail in each of 140 x 2
# blocks, where the 16-warp K6's last warps get part of a key tile or none
FLASH_WIDE = ((133, 9, 70), (140, 64, 2100))


# (B, M) of phase 9's checks of K2's key blocks: grids on either side of
# K2's halving (church64 G's 64 map at B = 64, church512's 512 map)
KEY_BLOCK_GRIDS = ((1, 100), (2, 2100), (2, 16384), (64, 1024), (2, 65536),
                   (8, 65536), (13, 65536))


def phase_flash_all_widths() -> None:
    """Every (dtype, engine, d, c) instance of K3-K6 against the plain
    versions at ``FLASH_RAGGED`` and ``FLASH_WIDE``: bf16 on the tensor
    cores and on the CUDA cores, fp32 on the CUDA cores; each library's
    K6 key block against the one the route rule sizes the slab by, the
    tensor-core K6's 16 warps at d <= 16 (8 at d = 32); and at each of
    ``KEY_BLOCK_GRIDS`` K2's gradient pass's key blocks against
    ``k2_key_blocks``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in cuda_attention.SUPPORTED_C:
        for d in cuda_attention.SUPPORTED_D:
            for engine, itemsize in (("mma", 2), ("fma", 4)):
                got = cuda_attention.keys_per_block(d, c, engine=engine)
                want = fused_keys_per_block(d, c, itemsize)
                require(got == want, f"K6 ({engine}) at d={d} c={c}: "
                        f"{got} keys a block, the route counts {want}")
            warps = MMA_K6_WARPS if d <= 16 else 8
            require(k6_warps(d) == warps and cuda_attention.keys_per_block(
                d, c) == warps * 16 * mma_key_tiles(d, c),
                f"K6 (mma) at d={d} c={c}: not {warps} warps a block")
            for b, m in KEY_BLOCK_GRIDS:
                got = cuda_attention.bwd_mma_key_blocks(b, m, d, c)
                want = k2_key_blocks(b, m, d, c, sms)
                require(got == want, f"K2 at B={b} M={m} d={d} c={c}: {got} "
                        f"key blocks, the rule counts {want}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    worst, count = {}, 0
    for b, n, m in FLASH_RAGGED + FLASH_WIDE:
        for dtype, engine in ((torch.bfloat16, "mma"),
                              (torch.bfloat16, "fma"),
                              (torch.float32, "fma")):
            for d in cuda_attention.SUPPORTED_D:
                for c in cuda_attention.SUPPORTED_C:
                    share = _flash_errors(
                        *_bwd_inputs(gen, b, n, m, d, c, dtype), dtype,
                        engine)
                    key = f"{str(dtype).removeprefix('torch.')} {engine}"
                    worst[key] = max(worst.get(key, 0.0), share)
                    count += 1
                    require(share <= 1, f"flash kernels ({engine}) at B={b} "
                            f"N={n} M={m} d={d} c={c} {dtype}: {share:.3f} "
                            f"of tolerance")
    print(f"phase 9 kernels attention_flash_fwd/dq/dkv/dqkv, all {count} "
          f"(dtype, engine, d, c, shape) instances at (B, N, M) in "
          f"{FLASH_RAGGED + FLASH_WIDE}: worst error as a share of its "
          "tolerance "
          + ", ".join(f"{key} {x:.3f}" for key, x in worst.items())
          + "; the tensor-core K5's dk, dv equal to K6's bit for bit; every "
            "K6 key block as the route rule counts it (the tensor-core K6 "
            "16 warps at d <= 16, 8 at d = 32) and every K2 key block count "
            f"as k2_key_blocks does, at {len(KEY_BLOCK_GRIDS)} grids",
          flush=True)


# the launch counters by kernel: K1-K6 on the CUDA cores ("K1" ... "K6")
# and on the tensor cores ("K1mma" ... "K6mma")
COUNTERS = {"K1": "LAUNCHES", "K2": "BWD_LAUNCHES",
            "K1mma": "FWD_MMA_LAUNCHES", "K2mma": "BWD_MMA_LAUNCHES",
            "K3": "FLASH_FWD_LAUNCHES", "K3mma": "FLASH_FWD_MMA_LAUNCHES",
            "K4": "FLASH_DQ_LAUNCHES", "K4mma": "FLASH_DQ_MMA_LAUNCHES",
            "K5": "FLASH_DKV_LAUNCHES", "K5mma": "FLASH_DKV_MMA_LAUNCHES",
            "K6": "FLASH_DQKV_LAUNCHES", "K6mma": "FLASH_DQKV_MMA_LAUNCHES"}


# K7's counters: grouped forward calls ("K7"), the weights they
# normalized ("K7w"), grouped backward calls ("K7bwd")
SN_COUNTERS = {"K7": "LAUNCHES", "K7w": "WEIGHTS", "K7bwd": "BWD_LAUNCHES"}


def _zero_counts() -> None:
    for name in COUNTERS.values():
        setattr(cuda_attention, name, 0)
    for name in SN_COUNTERS.values():
        setattr(cuda_spectral, name, 0)


def _counts() -> dict:
    """Launches since the last ``_zero_counts``, by kernel."""
    return {key: getattr(cuda_attention, name)
            for key, name in COUNTERS.items()} | {
        key: getattr(cuda_spectral, name)
        for key, name in SN_COUNTERS.items()}


def _launches(**some) -> dict:
    """Every counter's expected launches: ``some``, and 0 for the rest."""
    return {key: some.get(key, 0) for key in (*COUNTERS, *SN_COUNTERS)}


def phase_flash_autograd() -> dict:
    """``FlashAttention`` through ``attention()`` at a small flash-routed
    shape, gradients against autograd through the plain forward: bf16
    through the tensor-core K3 and K6, fp32 through the CUDA-core ones;
    then again with ``DQ_SLAB_BUDGET`` 0, so that the backward takes K4 +
    K5 (bf16: the delta pass, the tensor-core K4 and K5).  Returns the
    fp32 run's launches within the budget (the fp32 path of the op)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    b, n, m, d, c = 2, 1024, 8192, 2, 8
    budget = attention_ops.DQ_SLAB_BUDGET
    kept = None
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = _bwd_inputs(gen, b, n, m, d, c, dtype)
        name = str(dtype).removeprefix("torch.")
        mark = "mma" if dtype == torch.bfloat16 else ""
        for past in (False, True):
            attention_ops.DQ_SLAB_BUDGET = 0 if past else budget
            try:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                _zero_counts()
                out = attention(*leaves)
                got = torch.autograd.grad(out, leaves, g)
                counts = _counts()
                fused = flash_bwd_fused(b, n, m, d, c, q.element_size())
            finally:
                attention_ops.DQ_SLAB_BUDGET = budget
            ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(attention_reference(*ref_leaves),
                                       ref_leaves, g)
            share, err = _grad_errors(got, want, BWD_TOL[dtype])
            print(f"phase 10 FlashAttention B={b} N={n} M={m} d={d} c={c} "
                  f"{name}{', slab budget 0 (K4 + K5)' if past else ''}: "
                  f"gradients vs autograd through the plain forward "
                  f"max_abs_err {err:.3g}, worst {share:.3f} of tol "
                  f"{BWD_TOL[dtype]:g} x max|plain|; launches {counts}",
                  flush=True)
            require(share <= 1 and fused != past, f"FlashAttention "
                    f"gradients {name}: {share:.3f} of tolerance")
            kinds = ("K3", "K4", "K5") if past else ("K3", "K6")
            want = _launches(**{kind + mark: 1 for kind in kinds})
            require(counts == want, f"FlashAttention launched {counts}, "
                    f"expected {want}")
            if dtype == torch.float32 and not past:
                kept = counts
    return kept


def church512_config(dtype: str) -> dict:
    config = resolve_config(load_config_file(str(CHURCH512)))
    config.update(img_size=512, num_classes=1, compute_dtype=dtype)
    return config


def _church512_nets(config, seed):
    """Seeded church512 G and D (CPU) with every attention sigma nonzero."""
    gen = get_generator(config, rng=torch.Generator().manual_seed(seed))
    disc = get_discriminator(config,
                             rng=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        for mod in (m for net in (gen, disc) for m in net.modules()
                    if isinstance(m, SelfAttention)):
            mod.sigma.fill_(0.5)
    return gen, disc


def _calibrate_bn(gen) -> None:
    """Set every BN's running statistics to the moments of one train-mode
    batch (momentum 0 for that forward).  At init the eval-mode BN (mean
    0, var 1) shrinks G's activations ~3x a stage: after church512's 7
    stages its output is ~1e-4, one uint8 value everywhere."""
    momentum = layers.BN_MOMENTUM
    layers.BN_MOMENTUM = 0.0
    z = torch.randn(4, 128, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED + 31))
    try:
        gen.train()
        with torch.no_grad():
            gen(z, torch.zeros(4, dtype=torch.long, device="cuda"))
    finally:
        layers.BN_MOMENTUM = momentum
        gen.eval()


def phase_serve512(card: str) -> dict:
    """church512 served: fp32 G (BN statistics of one batch) through the
    CUDA-core K3 against the chunked plain forward on the card, then bf16
    over HTTP through the tensor-core K3.  Returns the launches of the
    HTTP path ("serve", tensor-core K3) and of the fp32 forward ("fp32",
    CUDA-core K3)."""
    gen32, _ = _church512_nets(church512_config("float32"), SEED + 30)
    gen32.to("cuda")
    _calibrate_bn(gen32)
    plain = copy.deepcopy(gen32)
    for mod in plain.modules():
        if isinstance(mod, SelfAttention):
            mod.use_pallas = False
    z = torch.randn(1, 128, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    labels = torch.zeros(1, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        _zero_counts()
        got = gen32(z, labels)
        torch.cuda.synchronize()
        counts = fp32_counts = _counts()
        t0 = time.perf_counter()
        want = plain(z, labels)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    std = want.std().item()
    print(f"phase 11 church512 G fp32 B=1 through K3 vs use_pallas=False "
          f"(chunked plain, {plain_s:.2f} s) on the card: shape "
          f"{tuple(got.shape)} max_abs_err {err:.3g} (tol {G_TOL:g}), "
          f"output std {std:.3g}; launches {counts} on {card}", flush=True)
    require(err <= G_TOL and got.shape == (1, 3, 512, 512) and std > 1e-2
            and counts == _launches(K3=1) and bool(torch.isfinite(got).all()),
            "church512 G through K3 disagrees with the plain forward")
    del plain, got, want

    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    config = church512_config("bfloat16")
    weights = export_generator_npz(gen32.cpu(),
                                   str(smoke_dir / "church512_g.npz"), config)
    del gen32
    _zero_counts()                   # the serving path starts here
    t0 = time.perf_counter()
    gen = load_generator_npz(config, weights, "cuda")
    svc = GeneratorService(gen, z_dim=config["z_dim"], num_classes=1,
                           batch=4, ladder=(1,))
    startup_s = time.perf_counter() - t0
    forwards = len(svc.ladder)
    srv = make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        status, _, body, _ = _get(base + "/meta")
        meta = json.loads(body)
        require(status == 200 and meta["img_size"] == 512
                and meta["ladder"] == [1, 4], meta)
        for n in (1, 4):
            times = []
            for rep in range(3):
                status, headers, body, sec = _get(
                    f"{base}/sample?n={n}&seed={rep}&format=raw")
                forwards += len(list(svc._chunks(n)))
                imgs = np.frombuffer(body, np.uint8).reshape(n, 512, 512, 3)
                require(status == 200
                        and headers["X-Image-Shape"] == f"{n}x512x512x3",
                        headers)
                require(imgs.std() > 0, "served images are constant")
                times.append(sec * 1e3)
            print(f"phase 11 serve church512 /sample?n={n}&format=raw: 200, "
                  f"{n}x512x512x3 uint8; latency ms median "
                  f"{statistics.median(times):.2f} of {len(times)} "
                  f"({', '.join(f'{t:.2f}' for t in times)}); startup "
                  f"{startup_s:.2f} s on {card}", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=30)
    counts = _counts()               # the serving path ends here
    print(f"phase 11 serve church512: launches {counts} for {forwards} "
          f"generator forwards (one attention site each, on the flash "
          f"path)", flush=True)
    require(counts == _launches(K3mma=forwards),
            f"expected {forwards} tensor-core K3 launches only, counted "
            f"{counts}")
    return {"serve": counts["K3mma"], "fp32": fp32_counts["K3"]}


def _site_norms(names, norms, side: int) -> dict:
    """{name: gradient norm} of attention site ``side``'s theta/phi/g."""
    return {n: float(x) for n, x in zip(names, norms)
            if re.fullmatch(rf"attn{side}\.(theta|phi|g)\.w", n)}


def phase_train512(card: str) -> dict:
    """Train church512 through the entry point for one epoch on synthetic
    512 px records.  Returns the launches by kernel."""
    smoke = ROOT / "build" / "smoke"
    data = smoke / "church512_synthetic"
    for sub in ("ckpt512", "logs512", "images512"):
        shutil.rmtree(smoke / sub, ignore_errors=True)
    if not (data / "metadata.pickle").exists():
        t0 = time.perf_counter()
        make_synthetic_dataset(str(data), num=SMOKE512_RECORDS, img_size=512,
                               num_classes=1, seed=SEED)
        print(f"phase 12 data: {SMOKE512_RECORDS} synthetic 512 px records "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    config_file = smoke / "church512_smoke.py"
    config_file.write_text(
        f"import runpy\n"
        f"config = dict(runpy.run_path({str(CHURCH512)!r})['config'])\n"
        f"config.update(data_path={str(data)!r}, epoch=1, fid_epoch_freq=0, "
        f"ckpt_dir={str(smoke / 'ckpt512')!r}, "
        f"log_dir={str(smoke / 'logs512')!r}, "
        f"img_dir={str(smoke / 'images512')!r}, print_variables=False)\n")

    fetched = []
    fetch = Trainer._fetch

    def kept(self, metrics):
        out = fetch(self, metrics)
        fetched.append(dict(out))
        return out

    grids = []
    sample = Trainer.sample_images

    def counted(self):
        grids.append(1)
        return sample(self)

    Trainer._fetch, Trainer.sample_images = kept, counted
    out = io.StringIO()
    try:
        _zero_counts()               # the training path starts here
        with contextlib.redirect_stdout(out):
            trainer = train_cli.main(["--config_path", str(config_file),
                                      "--device", "cuda"])
        torch.cuda.synchronize()
        counts = _counts()           # the training path ends here
    finally:
        Trainer._fetch, Trainer.sample_images = fetch, sample
    text = out.getvalue()
    epochs = re.findall(r"^epoch (\d+): G_loss=(\S+) D_loss=(\S+) .*"
                        r"\(([\d.]+) imgs/s, ([\d.]+) ms/step\)$", text,
                        re.MULTILINE)
    steps = trainer.global_step()
    for epoch, g_loss, d_loss, imgs_s, ms_step in epochs:
        print(f"phase 12 train church512 epoch {epoch}: G_loss {g_loss} "
              f"D_loss {d_loss}, {imgs_s} imgs/s, {ms_step} ms/step (host "
              f"clock over the epoch, loader and first-call set-up "
              f"included) on {card}", flush=True)
        require(math.isfinite(float(g_loss)) and math.isfinite(float(d_loss)),
                f"church512 losses are not finite: {g_loss} {d_loss}")
    norms = _site_norms(trainer.train_step.g_names,
                        fetched[-1]["G_grad_norms"], 512)
    want = _launches(K1mma=2 * steps, K2mma=2 * steps,
                     K3mma=2 * steps + len(grids), K6mma=steps)
    print(f"phase 12 train church512: {steps} steps at B=4, {len(grids)} "
          f"sample-grid forwards; launches {counts} (expected {want}); "
          f"512-site gradient norms of the last call {norms}", flush=True)
    require(len(epochs) == 1 and steps == SMOKE512_RECORDS // 4,
            f"church512 run: {len(epochs)} epochs, {steps} steps")
    require(counts == want, f"church512 launches {counts}, expected {want}")
    require(len(norms) == 3 and min(norms.values()) > 0,
            f"512-site attention weights without a gradient: {norms}")
    return counts


def phase_step512_b8(card: str) -> dict:
    """One church512 training step at B=8 (the config's learning rates):
    in bf16 the tensor-core K6's dq partials (2,048 keys a block) are
    536.9 MB, inside ``DQ_SLAB_BUDGET``, so the G backward takes K6; at
    B=16 in bf16 they would be 1.07 GB, past it, and at B=8 in fp32 the
    CUDA-core K6's (1,024 keys a block) too, so those take K4 + K5 (the
    tensor-core ones after one delta pass, then the CUDA-core ones).
    Returns {"bfloat16" (B=8), "bfloat16_b16", "float32" (B=8): the
    launches by kernel}."""
    out = {}
    for key, dtype, batch, backward in (
            ("bfloat16", "bfloat16", 8, {"K6mma": 1}),
            ("bfloat16_b16", "bfloat16", 16, {"K4mma": 1, "K5mma": 1}),
            ("float32", "float32", 8, {"K4": 1, "K5": 1})):
        config = church512_config(dtype)
        config.update(batch_size=batch, global_batch_size=batch)
        gen, disc = _church512_nets(config, SEED + 40)
        gen.to("cuda").train()
        disc.to("cuda").train()
        (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
            config, gen.parameters(), disc.parameters(), steps_per_epoch=1)
        state = TrainState(gen, disc, opt_g, opt_d, 0, None)
        step = build_train_step(config, sched_g, sched_d, gen, disc)
        images = torch.randint(
            0, 256, (1, batch, 512, 512, 3), dtype=torch.uint8,
            device="cuda",
            generator=torch.Generator("cuda").manual_seed(SEED))
        labels = torch.zeros(1, batch, dtype=torch.int32, device="cuda")
        _zero_counts()               # the step starts here
        t0 = time.perf_counter()
        metrics = step(state, images, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()           # and ends here
        norms = _site_norms(step.g_names, metrics["G_grad_norms"].cpu(), 512)
        losses = {k: float(metrics[k]) for k in ("G_loss", "D_loss")}
        mark = "mma" if dtype == "bfloat16" else ""
        want = _launches(**{"K1" + mark: 2, "K2" + mark: 2, "K3" + mark: 2},
                         **backward)
        print(f"phase 13 church512 train step B={batch} {dtype}: losses "
              f"{losses}, {seconds:.2f} s (first step, host clock); "
              f"launches {counts} (expected {want}); 512-site gradient "
              f"norms {norms} on {card}", flush=True)
        require(all(math.isfinite(x) for x in losses.values()),
                f"B={batch} losses are not finite: {losses}")
        require(counts == want, f"B={batch} {dtype} step launches {counts}, "
                                f"expected {want}")
        require(len(norms) == 3 and min(norms.values()) > 0,
                f"512-site attention weights without a gradient: {norms}")
        out[key] = counts
        del gen, disc, state, step, opt_g, opt_d
    return out


IMAGENET128 = ROOT / "example_configs" / "imagenet128_cond.py"
PAPER_GF64 = ROOT / "example_configs" / "imagenet128_paper_gf64.py"
SN_EPS = 1e-12
# K7 against its plain version on the same inputs, fp32: W_bar, u_new, v and
# sigma within SN_TOL x max|plain| (the same multiply-and-reduce, summed in
# another order); the gradient within SN_GRAD_TOL x max|plain| (the same
# closed form, from <g, W> summed in another order; through autograd, the
# plain "xla" function's v and u of two iterations in other orders)
SN_TOL = 1e-5
SN_GRAD_TOL = 1e-4
# grouped K7 calls, and the weights they normalize, a training step of
# imagenet128_cond: each of the 2 D updates runs G for the fakes (25 SN
# weights) and one fused D forward (28); the G update runs G and D once
# more.  Its backward runs once a D update (D's table) and once for the G
# update (G's: the G step asks for no gradient of D's weights)
SN_CALLS_PER_STEP = 6
SN_PER_STEP = 2 * (25 + 28) + 25 + 28
SN_BWD_PER_STEP = 3
SN_PER_G = 25
# synthetic labelled 128 px records of the imagenet128_cond run: 8 steps an
# epoch at B=64, 2 calls of steps_per_call 4
SMOKE128_RECORDS = 512
SMOKE128_BATCH = 64
PAPER_BATCH = 64


def imagenet_config(path: Path, dtype: str, **extra) -> dict:
    config = resolve_config(load_config_file(str(path)))
    config.update(img_size=128, num_classes=1000, compute_dtype=dtype,
                  **extra)
    return config


def sn_tables() -> dict:
    """{(config, net): [(layer, weight shape, out_dim)]} of every spectrally
    normalized weight of imagenet128_cond's and imagenet128_paper_gf64's G
    and D, in ``named_modules`` order (a grouped call's table), from their
    nets built on the meta device."""
    tables = {}
    for path in (IMAGENET128, PAPER_GF64):
        config = imagenet_config(path, "float32")
        with torch.device("meta"):
            nets = (("G", get_generator(config)),
                    ("D", get_discriminator(config)))
        for tag, net in nets:
            tables[path.stem, tag] = [
                (f"{tag}.{name}", tuple(m.w.shape), m.out_dim)
                for name, m in net.named_modules()
                if isinstance(m, layers._SNLayer) and m.sn]
    return tables


def sn_bound_ms(views, n_iter: int = 1,
                wbar_bytes: int = 4) -> tuple[float, str]:
    """Least time of one grouped K7 call over weights of (A, O, R)
    ``views``: each W read once, each W_bar written once (``wbar_bytes``
    an element), u read, u_new, v and sigma written (fp32) over the HBM
    rate, or the (4 n_iter + 1) F O fp32 operations over the fp32 peak."""
    nbytes = ops = 0
    for a, o, r in views:
        n, f = a * o * r, a * r
        nbytes += (4 + wbar_bytes) * n + 4 * (2 * o + f + 1)
        ops += (4 * n_iter + 1) * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def sn_bwd_bound_ms(views, g_bytes: int) -> tuple[float, str]:
    """Least time of one grouped K7 backward over weights of ``views``: g
    and W read, dW written once, u, v and sigma read; or its ~5 operations
    an element (the dot and dW) over the fp32 peak."""
    nbytes = sum((g_bytes + 8) * a * o * r + 4 * (o + a * r + 1)
                 for a, o, r in views)
    ops = sum(5 * a * o * r for a, o, r in views)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def device_ms(fn, iters: int = 10, flush: bool = True) -> float:
    """Mean device time of one ``fn`` call between CUDA events around the
    call alone, with the L2 cache flushed before it (a 256 MB write) when
    ``flush``: a weight is cold when a training step reaches its layer.
    The card sleeps ~5 ms before each start event, so the host has
    enqueued the call's kernels before the events' span begins and the
    span is the kernels' own."""
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        if flush:
            scrub.zero_()
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _sn_inputs(table, gen):
    ws, us = [], []
    for _, shape, out_dim in table:
        o = shape[out_dim]
        ws.append(0.05 * torch.randn(shape, device="cuda", generator=gen))
        u = torch.randn(o, device="cuda", generator=gen)
        us.append(u / torch.linalg.vector_norm(u))
    return ws, us


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def phase_sn_kernels(card: str) -> dict:
    """The grouped K7 against its plain version on the card, over G's and
    D's whole tables of imagenet128_cond and imagenet128_paper_gf64, fp32:
    W_bar, u_new, v and sigma per weight; u stored where asked and only
    there; the bf16 W_bar the fp32 one rounded; the backward (fp32 and
    bf16 g, one weight given none); the same bits on two calls;
    n_iter 2 and mixed; the gradient through SpectralNormGroup against
    autograd through the plain function.  Times of a grouped call over
    each imagenet128_cond table, both designs, and of a group of one at
    its G stem.  Returns the kernels line's rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    tables = sn_tables()
    worst = dict.fromkeys(("w_bar", "u_new", "v", "sigma", "grad"), 0.0)
    abs_err = {"fwd": 0.0, "bwd": 0.0}
    rows = {}
    for (config, net), table in tables.items():
        ws, us = _sn_inputs(table, gen)
        n = len(table)
        out_dims = [d for _, _, d in table]
        views = [cuda_spectral.sn_view(w.shape, d)
                 for w, d in zip(ws, out_dims)]
        ones = [1] * n
        # the kernel, twice (the same bits), with u stored on copies for
        # every other weight
        stored = [u.clone() for u in us]
        store = [i % 2 == 0 for i in range(n)]
        got, stats = cuda_spectral.sn_group_forward(
            ws, stored, ones, out_dims, SN_EPS, store=store)
        again, stats2 = cuda_spectral.sn_group_forward(ws, us, ones,
                                                       out_dims, SN_EPS)
        bf16, stats16 = cuda_spectral.sn_group_forward(
            ws, us, ones, out_dims, SN_EPS, dtype=torch.bfloat16)
        plan = cuda_spectral.group_plan(ws, ones, out_dims)
        parts = cuda_spectral.split_stats(stats, plan)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(stats, stats2) and torch.equal(stats,
                                                               stats16),
                f"K7 {config} {net}: two calls differ")
        require(all(torch.equal(b, a.to(torch.bfloat16))
                    for a, b in zip(got, bf16)),
                f"K7 {config} {net}: the bf16 W_bar is not the fp32 one "
                f"rounded")
        errs = dict.fromkeys(worst, 0.0)
        for i, (w, u) in enumerate(zip(ws, us)):
            want = cuda_spectral.spectral_norm_reference(w, u, 1, SN_EPS,
                                                         out_dims[i])
            for name, x, y in zip(("w_bar", "u_new", "v", "sigma"),
                                  (got[i], *parts[i]), want):
                require(x.shape == y.shape,
                        f"K7 {name} {tuple(x.shape)} vs {tuple(y.shape)}")
                errs[name] = max(errs[name], _rel(x, y))
                abs_err["fwd"] = max(abs_err["fwd"],
                                     (x - y).abs().max().item())
            require(torch.equal(stored[i], parts[i][0] if store[i] else u),
                    f"K7 {config} {table[i][0]}: u stored wrongly "
                    f"(store {store[i]})")
        # the backward: fp32 and bf16 g, the first weight given none
        for g_dtype in (torch.float32, torch.bfloat16):
            gs = [None] + [torch.randn(w.shape, device="cuda", generator=gen)
                           .to(g_dtype) for w in ws[1:]]
            dws = cuda_spectral.sn_group_backward(gs, ws, stats, ones,
                                                  out_dims, SN_EPS)
            dws2 = cuda_spectral.sn_group_backward(gs, ws, stats, ones,
                                                   out_dims, SN_EPS)
            require(dws[0] is None and all(
                torch.equal(a, b) for a, b in zip(dws[1:], dws2[1:])),
                f"K7 backward {config} {net}: a weight without a gradient "
                f"got one, or two calls differ")
            for i in range(1, n):
                want = cuda_spectral.sn_bwd_reference(
                    gs[i], ws[i], *parts[i], SN_EPS, out_dims[i])
                errs["grad"] = max(errs["grad"], _rel(dws[i], want))
                abs_err["bwd"] = max(abs_err["bwd"],
                                     (dws[i] - want).abs().max().item())
        for name, e in errs.items():
            worst[name] = max(worst[name], e)
        ok = all(e <= SN_TOL for k, e in errs.items() if k != "grad") \
            and errs["grad"] <= SN_GRAD_TOL
        print(f"phase 14 K7 {config} {net}: {n} weights "
              f"({sum(a * o * r for a, o, r in views)} elements) in one "
              f"grouped call, plan {plan.rows_items} rows items, "
              f"{plan.col_blocks} colsum blocks, {plan.chunks} finish "
              f"items, {plan.smem} B shared; errors / max|plain| "
              + " ".join(f"{k} {e:.2g}" for k, e in errs.items())
              + f"; u stored where asked; bf16 W_bar = fp32 rounded; two "
              f"calls bit for bit {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"K7 disagrees with its plain version on {config} "
                    f"{net}: {errs}")
        if config != IMAGENET128.stem:
            continue
        # timed: a grouped call over the table, bf16 W_bar (the main
        # path's), both designs, and fp32; the backward with bf16 g
        timed = {}
        for label, dtype, design in (
                ("bf16", torch.bfloat16, cuda_spectral.DESIGN),
                ("bf16 other design", torch.bfloat16,
                 1 - cuda_spectral.DESIGN),
                ("fp32", torch.float32, cuda_spectral.DESIGN)):
            call = functools.partial(
                cuda_spectral.sn_group_forward, ws, us, ones, out_dims,
                SN_EPS, dtype=dtype, design=design)
            if design != cuda_spectral.DESIGN:
                other = call()[0]
                require(all(torch.equal(a, b) for a, b in zip(other, bf16)),
                        f"K7 design {design} differs from design "
                        f"{cuda_spectral.DESIGN}")
            timed[label] = (device_ms(call), device_ms(call, flush=False),
                            sn_bound_ms(views, 1, dtype.itemsize))
        g16 = [torch.randn(w.shape, device="cuda", generator=gen).to(
            torch.bfloat16) for w in ws]
        bwd = functools.partial(cuda_spectral.sn_group_backward, g16, ws,
                                stats, ones, out_dims, SN_EPS)
        timed["backward bf16 g"] = (device_ms(bwd),
                                    device_ms(bwd, flush=False),
                                    sn_bwd_bound_ms(views, 2))

        def plain():
            for w, u, d in zip(ws, us, out_dims):
                cuda_spectral.spectral_norm_reference(w, u, 1, SN_EPS, d)

        def plain_bwd():
            for i in range(n):
                cuda_spectral.sn_bwd_reference(g16[i], ws[i], *parts[i],
                                               SN_EPS, out_dims[i])

        plain_ms, plain_bwd_ms = device_ms(plain), device_ms(plain_bwd)
        print(f"phase 14 K7 {config} {net} timed (ms a call, L2 flushed / "
              f"warm, bound): "
              + "; ".join(f"{k} {c:.4f} / {w_:.4f}, bound {b:.4g} ({by})"
                          for k, (c, w_, (b, by)) in timed.items())
              + f"; plain (weight by weight) {plain_ms:.4f}, its backward "
              f"{plain_bwd_ms:.4f}; shipped design {cuda_spectral.DESIGN} "
              f"on {card}", flush=True)
        if net == "G":
            ms, _, (bound, bound_by) = timed["bf16"]
            rows["fwd"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": bound_by, "library_ms": None}
            ms, _, (bound, bound_by) = timed["backward bf16 g"]
            rows["bwd"] = {"ms": ms, "plain_ms": plain_bwd_ms,
                           "bound_ms": bound, "bound_by": bound_by,
                           "library_ms": None}
            # a group of one at the stem, fp32 (PR 7's per-weight reading)
            i = next(k for k, (name, _, _) in enumerate(table)
                     if name == "G.stem")
            one = functools.partial(cuda_spectral.spectral_norm_fused, ws[i],
                                    us[i], 1, SN_EPS, out_dims[i])
            bound, bound_by = sn_bound_ms([views[i]])
            print(f"phase 14 K7 group of one at {table[i][0]} "
                  f"{list(table[i][1])} fp32: ms {device_ms(one):.4f} (L2 "
                  f"flushed; {device_ms(one, flush=False):.4f} warm) bound "
                  f"{bound:.4g} ({bound_by}) on {card}", flush=True)
    # the gradient through the autograd Function (one call over G's table
    # of imagenet128_cond) against autograd through the plain function
    table = tables[IMAGENET128.stem, "G"]
    ws, us = _sn_inputs(table, gen)
    out_dims = [d for _, _, d in table]
    ts = [torch.randn(w.shape, device="cuda", generator=gen) for w in ws]
    leaves = [w.clone().requires_grad_() for w in ws]
    w_bars = cuda_spectral.spectral_norm_group(
        leaves, us, [1] * len(ws), out_dims, SN_EPS)
    got = torch.autograd.grad(sum((b * t).sum() for b, t in zip(w_bars, ts)),
                              leaves)
    leaves = [w.clone().requires_grad_() for w in ws]
    want = torch.autograd.grad(sum(
        (spectral_normalize(w, u, 1, out_dim=d, backend="xla")[0] * t).sum()
        for w, u, d, t in zip(leaves, us, out_dims, ts)), leaves)
    err = max(_rel(a, b) for a, b in zip(got, want))
    # n_iter 2, and 1 and 2 in turn, on D's table of imagenet128_cond
    table = tables[IMAGENET128.stem, "D"]
    ws, us = _sn_inputs(table, gen)
    out_dims = [d for _, _, d in table]
    iters_err = 0.0
    for n_iters in ([2] * len(ws), [1 + i % 2 for i in range(len(ws))]):
        got, stats = cuda_spectral.sn_group_forward(ws, us, n_iters,
                                                    out_dims, SN_EPS)
        parts = cuda_spectral.split_stats(
            stats, cuda_spectral.group_plan(ws, n_iters, out_dims))
        for i, (w, u) in enumerate(zip(ws, us)):
            want = cuda_spectral.spectral_norm_reference(
                w, u, n_iters[i], SN_EPS, out_dims[i])
            iters_err = max(iters_err, *(_rel(x, y) for x, y in
                                         zip((got[i], *parts[i]), want)))
    print(f"phase 14 K7: all {len(tables)} tables "
          f"({sum(map(len, tables.values()))} weights) of imagenet128_cond "
          f"and imagenet128_paper_gf64, worst errors / max|plain| "
          + " ".join(f"{k} {e:.2g}" for k, e in worst.items())
          + f" (tol {SN_TOL:g}, gradient {SN_GRAD_TOL:g}); the gradient "
          f"through SpectralNormGroup vs autograd through the plain "
          f"function over G's table {err:.2g}; n_iter 2 and mixed on D's "
          f"table {iters_err:.2g}", flush=True)
    require(err <= SN_GRAD_TOL and iters_err <= SN_TOL,
            f"K7 autograd {err:.3g}, n_iter {iters_err:.3g}")
    rows["fwd"]["max_abs_err"] = abs_err["fwd"]
    rows["bwd"]["max_abs_err"] = abs_err["bwd"]
    return rows


def phase_generator128(card: str) -> None:
    """The full-width imagenet128_cond G in fp32 on the card (BN statistics
    of one batch) with use_pallas_sn against the same G with the plain SN,
    within G_SN_TOL; one grouped K7 call for its 25 SN weights."""
    config = imagenet_config(IMAGENET128, "float32", use_pallas_sn=True)
    gen = get_generator(config, rng=torch.Generator().manual_seed(SEED + 60))
    gen.to("cuda")
    _calibrate_bn(gen)
    plain = copy.deepcopy(gen)
    layers.set_sn_backend(plain, "xla")
    rng = torch.Generator("cuda").manual_seed(SEED + 61)
    z = torch.randn(8, 128, device="cuda", generator=rng)
    labels = torch.randint(0, 1000, (8,), device="cuda", generator=rng)
    with torch.inference_mode():
        _zero_counts()
        got = gen(z, labels)
        torch.cuda.synchronize()
        counts = _counts()
        want = plain(z, labels)
    err = (got - want).abs().max().item()
    std = want.std().item()
    print(f"phase 15 imagenet128_cond G fp32 B=8 with use_pallas_sn vs the "
          f"plain SN on the card: shape {tuple(got.shape)} max_abs_err "
          f"{err:.3g} (tol {G_SN_TOL:g}), output std {std:.3g}; launches "
          f"{counts} on {card}", flush=True)
    require(err <= G_SN_TOL and got.shape == (8, 3, 128, 128) and std > 1e-2
            and (counts["K7"], counts["K7w"], counts["K7bwd"], counts["K1"])
            == (1, SN_PER_G, 0, 2),
            "the imagenet128 G through K7 disagrees with the plain SN, or "
            "did not normalize its SN weights in one grouped K7 call")


def phase_train128(card: str) -> dict:
    """Train imagenet128_cond with use_pallas_sn through the entry point
    for 2 epochs on synthetic labelled 128 px records, restart it for a
    3rd.  Returns the first run's launches by kernel."""
    smoke = ROOT / "build" / "smoke"
    data = smoke / "imagenet128_synthetic"
    for sub in ("ckpt128", "logs128", "images128"):
        shutil.rmtree(smoke / sub, ignore_errors=True)
    if not (data / "metadata.pickle").exists():
        t0 = time.perf_counter()
        make_synthetic_dataset(str(data), num=SMOKE128_RECORDS, img_size=128,
                               num_classes=1000, seed=SEED)
        print(f"phase 16 data: {SMOKE128_RECORDS} synthetic 128 px records, "
              f"1000 classes, in {time.perf_counter() - t0:.1f} s", flush=True)
    files = {}
    for epochs in (2, 3):
        files[epochs] = smoke / f"imagenet128_smoke_e{epochs}.py"
        files[epochs].write_text(
            f"import runpy\n"
            f"config = dict(runpy.run_path({str(IMAGENET128)!r})['config'])\n"
            f"config.update(data_path={str(data)!r}, epoch={epochs}, "
            f"fid_epoch_freq=0, use_pallas_sn=True, "
            f"ckpt_dir={str(smoke / 'ckpt128')!r}, "
            f"log_dir={str(smoke / 'logs128')!r}, "
            f"img_dir={str(smoke / 'images128')!r}, print_variables=False)\n")
    results, first_step = {}, 0
    for label, epochs in (("run", 2), ("restart", 3)):
        trainer, text, counts, grids, n_epochs = _run_cli(
            files[epochs], card, f"16 imagenet128 {label}")
        steps = trainer.global_step() - first_step
        want = _launches(K1mma=12 * steps + 2 * grids, K2mma=8 * steps,
                         K7=SN_CALLS_PER_STEP * steps + grids,
                         K7w=SN_PER_STEP * steps + SN_PER_G * grids,
                         K7bwd=SN_BWD_PER_STEP * steps)
        print(f"phase 16 imagenet128 {label}: {steps} steps at B="
              f"{trainer.config['global_batch_size']}, "
              f"update_ratio 2, {grids} sample-grid forwards; launches "
              f"{counts} (expected {want}): grouped K7 "
              f"{(counts['K7'] - grids) / steps:g} calls for "
              f"{(counts['K7w'] - SN_PER_G * grids) / steps:g} weights a "
              f"step, its backward {counts['K7bwd'] / steps:g}", flush=True)
        require(trainer.config["num_classes"] == 1000
                and n_epochs == epochs - first_step // trainer.steps_per_epoch
                and trainer.global_step() == epochs * trainer.steps_per_epoch,
                f"{label}: {n_epochs} epochs, step {trainer.global_step()}")
        require(counts == want, f"imagenet128 {label}: launches {counts}, "
                                f"expected {want}")
        if first_step:
            require(f"Restored from checkpoint at step {first_step}" in text,
                    "the restart did not restore the checkpoint")
        else:
            require("Initializing from scratch." in text,
                    "the first run did not start from scratch")
        results[label] = counts
        first_step = trainer.global_step()
    return results["run"]


def phase_serve128(card: str) -> None:
    """Serve the imagenet128_cond checkpoint (EMA G, bf16, use_pallas_sn)
    over HTTP per class at n = 1 and 8."""
    config = resolve_config(load_config_file(
        str(ROOT / "build" / "smoke" / "imagenet128_smoke_e3.py")))
    _zero_counts()                   # the serving path starts here
    t0 = time.perf_counter()
    gen = generate.load_generator(config, None, "cuda")
    svc = GeneratorService(gen, z_dim=config["z_dim"],
                           num_classes=config["num_classes"], batch=8,
                           ladder=(1,))
    startup_s = time.perf_counter() - t0
    forwards = len(svc.ladder)
    srv = make_server(svc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        status, _, body, _ = _get(base + "/meta")
        meta = json.loads(body)
        require(status == 200 and meta["img_size"] == 128
                and meta["num_classes"] == 1000 and meta["ladder"] == [1, 8],
                meta)
        bodies = {}
        for n in (1, 8):
            times = []
            for rep, class_id in enumerate((207, 980, 207)):
                status, headers, body, sec = _get(
                    f"{base}/sample?n={n}&seed=5&class_id={class_id}"
                    f"&format=raw")
                forwards += len(list(svc._chunks(n)))
                imgs = np.frombuffer(body, np.uint8).reshape(n, 128, 128, 3)
                require(status == 200
                        and headers["X-Image-Shape"] == f"{n}x128x128x3",
                        headers)
                require(imgs.std() > 0, "served images are constant")
                bodies[n, rep] = body
                times.append(sec * 1e3)
            require(bodies[n, 0] == bodies[n, 2]
                    and bodies[n, 0] != bodies[n, 1],
                    "class_id does not pin the class")
            print(f"phase 17 serve imagenet128_cond /sample?n={n}&class_id="
                  f"207|980|207&format=raw: 200, {n}x128x128x3 uint8; "
                  f"latency ms {', '.join(f'{t:.2f}' for t in times)}; the "
                  f"same seed and class give identical bytes, another class "
                  f"others; startup {startup_s:.2f} s on {card}", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=30)
    counts = _counts()               # the serving path ends here
    want = _launches(K1mma=2 * forwards, K7=forwards,
                     K7w=SN_PER_G * forwards)
    print(f"phase 17 serve imagenet128_cond: launches {counts} for {forwards}"
          f" generator forwards (expected {want})", flush=True)
    require(counts == want, f"serving launches {counts}, expected {want}")


def phase_step_gf64(card: str) -> None:
    """One bf16 imagenet128_paper_gf64 training step (gf = df = 64,
    update_ratio 1) at B=64 with use_pallas_sn: its stem [1128, 16384] and
    1024-channel convolutions go through K7."""
    config = imagenet_config(PAPER_GF64, "bfloat16", use_pallas_sn=True)
    config.update(batch_size=PAPER_BATCH, global_batch_size=PAPER_BATCH)
    gen = get_generator(config, rng=torch.Generator().manual_seed(SEED + 70))
    disc = get_discriminator(config,
                             rng=torch.Generator().manual_seed(SEED + 71))
    gen.to("cuda").train()
    disc.to("cuda").train()
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        config, gen.parameters(), disc.parameters(), steps_per_epoch=1)
    state = TrainState(gen, disc, opt_g, opt_d, 0, None)
    step = build_train_step(config, sched_g, sched_d, gen, disc)
    rng = torch.Generator("cuda").manual_seed(SEED + 72)
    images = torch.randint(0, 256, (1, PAPER_BATCH, 128, 128, 3),
                           dtype=torch.uint8, device="cuda", generator=rng)
    labels = torch.randint(0, 1000, (1, PAPER_BATCH), dtype=torch.int32,
                           device="cuda", generator=rng)
    _zero_counts()                   # the step starts here
    t0 = time.perf_counter()
    metrics = step(state, images, labels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()               # and ends here
    losses = {k: float(metrics[k]) for k in ("G_loss", "D_loss")}
    params = sum(p.numel() for net in (gen, disc) for p in net.parameters())
    # one attention site a net (the 32 maps); update_ratio 1: G and D run
    # once for D's update and once for G's, a grouped K7 call each, and
    # K7's backward once for D's update and once for G's
    sn = sum(isinstance(m, layers._SNLayer) and m.sn
             for net in (gen, disc) for m in net.modules())
    want = _launches(K1mma=4, K2mma=3, K7=4, K7w=2 * sn, K7bwd=2)
    print(f"phase 18 imagenet128_paper_gf64 train step B={PAPER_BATCH} bf16 "
          f"({params} parameters in G and D): losses {losses}, "
          f"{seconds:.2f} s (first step, host clock); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; launches "
          f"{counts} (expected {want}) on {card}", flush=True)
    require(all(math.isfinite(x) for x in losses.values()),
            f"paper_gf64 losses are not finite: {losses}")
    require(counts == want, f"paper_gf64 launches {counts}, expected {want}")


def phase_legacy(card: str) -> None:
    """One epoch of the legacy CLI (``python -m
    sagan_tpu_torch.legacy_main``, in-process) on the imagenet128 records."""
    smoke = ROOT / "build" / "smoke"
    root = smoke / "legacy"
    shutil.rmtree(root, ignore_errors=True)
    out = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        trainer = legacy_main.main([
            "--data_path", str(smoke / "imagenet128_synthetic"),
            "--path_root", str(root), "-b", str(SMOKE128_BATCH), "-e", "1",
            "-n", "16",
            "--device", "cuda"])
    torch.cuda.synchronize()
    counts = _counts()
    epochs = re.findall(r"^epoch \d+: G_loss=(\S+) D_loss=(\S+) .*$",
                        out.getvalue(), re.MULTILINE)
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("epoch ")]
    print(f"phase 19 legacy CLI: {'; '.join(lines)}; {trainer.global_step()} "
          f"steps; launches {counts} on {card}", flush=True)
    require(len(epochs) == 1 and all(math.isfinite(float(x))
                                     for x in epochs[0])
            and trainer.global_step() == SMOKE128_RECORDS // SMOKE128_BATCH
            and any((root / "checkpoints").iterdir()),
            "the legacy CLI did not train its epoch")


# -- phases 20 and 21: the attention studies ---------------------------------

# study kernels vs their plain versions: max|kernel - plain| <= tol x
# max|plain|.  fp32 (the fma engine, S2): the same function summed in
# another order with the SFU exponential (~2 ulp); bf16, and any variant
# that rounds P to bf16 (e16): both round the output to bf16 (2^-8
# relative) and round P at other places (the kernels against the running
# max, the plain versions against the row's max): about two bf16 ulps
STUDY_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# the study shapes as phase 20 holds them: church64's 64 map whole, and
# a flash chunk of church256's and church512's maps (the first 4,096 query
# rows of one batch element against all M keys: the plain versions of the
# whole maps take seconds), and a ragged shape (N, M off the tiles and
# off 16)
STUDY_SITES = (("64 map", 64, 4096, 1024), ("256 map chunk", 1, 4096, 16384),
               ("512 map chunk", 1, 4096, 65536), ("ragged", 3, 100, 37))
STUDY_BWD_SITE = (2, 256 * 256, 128 * 128, 2, 8)  # K4-K6 tiles: B=2, 256 map
# the study maps whole, as the studies time them: (B, N, M), d = 2, c = 8
STUDY_MAPS = {"64 map": (64, 4096, 1024), "256 map": (16, 65536, 16384),
              "512 map": (4, 262144, 65536)}
# the H100 SXM's exponentials: 16 a clock on each of its SMs at its
# 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def _study_tol(dtype, variant: str = "") -> float:
    return STUDY_TOL[torch.bfloat16 if variant.endswith("e16") else dtype]


def sfu_floor_ms(b, n, m) -> float:
    """Least time of one exponential a (query, key) pair on the SFUs."""
    return b * n * m / SFU_EXP_PER_S * 1e3


def folded_bound_ms(b, n, m, dtype) -> tuple[float, str]:
    """Least time of one folded forward (v given): x, xb, w, v read once, o
    written once over the HBM rate, or its 2·B·N·(M·(Cin + c) + Cin²)
    FLOPs over the operand type's peak, whichever is larger."""
    cin, c = cuda_attention_study.CIN, cuda_attention_study.C
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (b * n * cin + b * m * cin + cin * cin + b * m * c
                     + b * n * c)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * n * (m * (cin + c) + cin * cin) / PEAK_FLOPS[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def phase_study_kernels(card: str) -> dict:
    """Build every study library (one nvcc each, all together), then hold
    every S1 variant, both S2 forms, every tile variant of K1 and K3-K6,
    every design flip of the tensor-core K1, K2, K4 and K5 and every
    (query tile, key block) point of the tensor-core K6 against the plain
    versions (``STUDY_TOL``, the flips and points ``TOL`` and
    ``BWD_TOL``), the S1 fma default against the CUDA-core K1 bit for bit
    and S1 mma_exp2 against the shipped tensor-core K1 or K3 (the route's
    pick) bit for bit, and the K2, K4 and K5 of each K6 point's library
    against the shipped ones bit for bit; time S1's tensor-core variants
    at the three study maps beside ``sdpa_padded``, and S2 in bf16 at the
    64 and 256 maps beside the shipped kernel on projected q, k.  Returns
    their rows of the kernels line and the K6 points' worst shares."""
    t0 = time.perf_counter()
    paths = _build.build(cuda_attention_study.build_specs())
    print(f"phase 20 build: {len(paths)} study libraries in "
          f"{time.perf_counter() - t0:.1f} s; {_build_report(paths)}",
          flush=True)
    cas = cuda_attention_study
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    heads = {}

    # S1, every variant at every site, bf16 and (fma engine) fp32
    worst = {name: (0.0, 0.0, "") for name in VARIANTS}
    for site, b, n, m in STUDY_SITES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = _bwd_inputs(gen, b, n, m, 2, 8, dtype)
            chunk = plain_chunk(b, n, m)
            for variant, (engine, _, _) in VARIANTS.items():
                if engine == "mma" and dtype == torch.float32:
                    continue
                got = cas.attention_study(q, k, v, variant)
                want = study_attention_reference(q, k, v, variant, chunk)
                share, err = _grad_errors((got,), (want,),
                                          _study_tol(dtype, variant))
                if share >= worst[variant][0]:
                    worst[variant] = (share, err, f"{site} {dtype}")
                require(share <= 1, f"attention_study {variant} at {site} "
                        f"{dtype}: {share:.3f} of its tolerance")
            if site == "64 map":
                same = torch.equal(cas.attention_study(q, k, v, "fma"),
                                   cuda_attention.attention_fused(
                                       q, k, v, engine="fma"))
                print(f"phase 20 attention_study fma vs K1 at church64's 64 "
                      f"map B={b} {dtype}: bit-identical {same}", flush=True)
                require(same, f"attention_study fma is not K1's bits {dtype}")
            if dtype == torch.bfloat16:
                # mma_exp2 is the shipped body: the route's K1 or K3 bits
                kind = "K1" if single_pass(m, 2, 8) else "K3"
                shipped = (cuda_attention.attention_fused(q, k, v)
                           if kind == "K1" else
                           cuda_attention.attention_flash_fwd(q, k, v)[0])
                same = torch.equal(cas.attention_study(q, k, v, "mma_exp2"),
                                   shipped)
                print(f"phase 20 attention_study mma_exp2 vs the shipped "
                      f"tensor-core {kind} at {site} B={b} N={n} M={m}: "
                      f"bit-identical {same}", flush=True)
                require(same, f"attention_study mma_exp2 is not {kind}'s "
                              f"bits at {site}")
    for variant, (share, err, where) in worst.items():
        print(f"phase 20 kernel attention_study {variant}: worst "
              f"{share:.3f} of its tolerance (max_abs_err {err:.3g} at "
              f"{where}) over {', '.join(s[0] for s in STUDY_SITES)}",
              flush=True)

    # S1's tensor-core variants (builds of the shipped K1/K3 body) at the
    # study maps whole, sdpa_padded beside them; mma_exp2, the shipped
    # kernel, timed first and again last for the run's drift
    order = ["mma_exp2"] + [name for name, (engine, _, _) in VARIANTS.items()
                            if engine == "mma" and name != "mma_exp2"]
    for site, (b, n, m) in STUDY_MAPS.items():
        q, k, v, _ = _bwd_inputs(gen, b, n, m, 2, 8, torch.bfloat16)
        row = {}
        for variant in order:
            row[variant] = cuda_time_ms(cas.attention_study, q, k, v, variant,
                                        iters=10, reps=3, warmup=2)[0]
        row["sdpa_padded"] = cuda_time_ms(sdpa_padded, q, k, v, iters=10,
                                          reps=3, warmup=2)[0]
        row["mma_exp2 again"] = cuda_time_ms(
            cas.attention_study, q, k, v, "mma_exp2", iters=10, reps=3,
            warmup=2)[0]
        print(f"phase 20 attention_study tensor-core variants at the {site} "
              f"B={b} N={n} M={m} bf16 ({mma_entry(m)} builds), ms: "
              + ", ".join(f"{key} {ms:.4f}" for key, ms in row.items())
              + f"; SFU floor {sfu_floor_ms(b, n, m):.4f}; bound "
              f"{attention_bound_ms(b, n, m, 2, 8, torch.bfloat16)[0]:.5f} "
              f"on {card}", flush=True)
        del q, k, v

    # S1's row of the kernels line: the mma variant at the 64 map, bf16
    _, b, n, m = STUDY_SITES[0]
    q, k, v, _ = _bwd_inputs(gen, b, n, m, 2, 8, torch.bfloat16)
    err = _grad_errors((cas.attention_study(q, k, v, "mma"),),
                       (study_attention_reference(q, k, v, "mma"),), 1.0)[1]
    bound = attention_bound_ms(b, n, m, 2, 8, torch.bfloat16)
    heads["study"] = {
        "max_abs_err": err,
        "ms": cuda_time_ms(lambda: cas.attention_study(q, k, v, "mma"))[0],
        "plain_ms": cuda_time_ms(lambda: study_attention_reference(
            q, k, v, "mma"))[0],
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": cuda_time_ms(sdpa_padded, q, k, v)[0],
        "at": f"variant mma, G 64map B={b} N={n} M={m} d=2 c=8 bfloat16"}
    print(f"phase 20 kernel attention_study timed: {heads['study']} on "
          f"{card}", flush=True)

    # S2, both forms, vs folded_reference
    cin = cas.CIN
    share_f = 0.0
    for site, b, n, m in STUDY_SITES[:2] + STUDY_SITES[3:]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, n, cin, device="cuda", generator=gen)
            xb = torch.randn(b, m, cin, device="cuda", generator=gen)
            w = torch.randn(cin, cin, device="cuda", generator=gen) / 8
            v = torch.randn(b, m, 8, device="cuda", generator=gen)
            wg = torch.randn(cin, 8, device="cuda", generator=gen) / 4
            x, xb, w, v, wg = (t.to(dtype) for t in (x, xb, w, v, wg))
            chunk = plain_chunk(b, n, m)
            for form in ({"v": v}, {"wg": wg}):
                share, err = _grad_errors(
                    (cas.attention_folded(x, xb, w, **form),),
                    (folded_reference(x, xb, w, **form, chunk=chunk),),
                    _study_tol(dtype))
                share_f = max(share_f, share)
                require(share <= 1, f"attention_folded {list(form)} at "
                        f"{site} {dtype}: {share:.3f} of its tolerance")
            if site == "64 map" and dtype == torch.bfloat16:
                err = _grad_errors((cas.attention_folded(x, xb, w, v=v),),
                                   (folded_reference(x, xb, w, v=v),),
                                   1.0)[1]
                bound = folded_bound_ms(b, n, m, dtype)
                heads["folded"] = {
                    "max_abs_err": err,
                    "ms": cuda_time_ms(lambda: cas.attention_folded(
                        x, xb, w, v=v))[0],
                    "plain_ms": cuda_time_ms(lambda: folded_reference(
                        x, xb, w, v=v))[0],
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": None,
                    "at": f"v given, G 64map B={b} N={n} M={m} Cin={cin} "
                          f"c=8 bfloat16"}
    print(f"phase 20 kernel attention_folded, v given and V = xb Wg, at "
          f"{', '.join(s[0] for s in STUDY_SITES[:2] + STUDY_SITES[3:])}, "
          f"bf16 and fp32: worst {share_f:.3f} of its tolerance; timed: "
          f"{heads['folded']} on {card}", flush=True)
    # S2 in bf16 (v given) at the 64 and 256 maps whole, beside the shipped
    # kernel (K1 or K3) on q = x W_theta, k = xb W_phi, with and without
    # those two projections: does the fold pay on the tensor cores?
    for site in ("64 map", "256 map"):
        b, n, m = STUDY_MAPS[site]
        x = torch.randn(b, n, cin, device="cuda", generator=gen)
        xb = torch.randn(b, m, cin, device="cuda", generator=gen)
        wth = torch.randn(cin, 2, device="cuda", generator=gen) / 4
        wph = torch.randn(cin, 2, device="cuda", generator=gen) / 4
        v = torch.randn(b, m, 8, device="cuda", generator=gen)
        x, xb, wth, wph, v = (t.to(torch.bfloat16)
                              for t in (x, xb, wth, wph, v))
        w = (wth.float() @ wph.float().T).to(torch.bfloat16)
        qp, kp = torch.matmul(x, wth), torch.matmul(xb, wph)
        timing = {"iters": 10, "reps": 3, "warmup": 2}
        row = {"folded": cuda_time_ms(lambda: cas.attention_folded(
            x, xb, w, v=v), **timing)[0],
               "shipped_projected_qk": cuda_time_ms(
                   attention, qp, kp, v, **timing)[0],
               "shipped_with_projections": cuda_time_ms(
                   lambda: attention(torch.matmul(x, wth),
                                     torch.matmul(xb, wph), v),
                   **timing)[0]}
        bound = folded_bound_ms(b, n, m, torch.bfloat16)
        print(f"phase 20 attention_folded bf16 (v given) at the {site} "
              f"B={b} N={n} M={m} Cin={cin} c=8, ms: "
              + ", ".join(f"{key} {ms:.4f}" for key, ms in row.items())
              + f"; bound {bound[0]:.5f} ({bound[1]}); SFU floor "
              f"{sfu_floor_ms(b, n, m):.4f} on {card}", flush=True)
        del x, xb, v, qp, kp

    # K1 and K3 at every forward tile point, vs the plain forward whose
    # arithmetic they share (fp32 P: the study's "fma"); K3's lse vs the
    # plain flash forward's
    share_t = 0.0
    for site, b, n, m in STUDY_SITES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = _bwd_inputs(gen, b, n, m, 2, 8, dtype)
            chunk = plain_chunk(b, n, m)
            want = study_attention_reference(q, k, v, "fma", chunk)
            want_lse = attention_flash_reference(q, k, v, chunk)[1]
            tol = _study_tol(dtype)
            for point in cas.FWD_POINTS:
                tiles = cas.fwd_tiles(point)
                o, lse = cuda_attention.attention_flash_fwd(q, k, v, tiles,
                                                            "fma")
                fused = cuda_attention.attention_fused(q, k, v, tiles, "fma")
                share = max(
                    _grad_errors((fused, o), (want, want), tol)[0],
                    (lse - want_lse).abs().max().item()
                    / (LSE_TOL * max(1.0, want_lse.abs().max().item())))
                share_t = max(share_t, share)
                require(share <= 1, f"K1/K3 at tiles {point} at {site} "
                        f"{dtype}: {share:.3f} of its tolerance")
    print(f"phase 20 K1 and K3 at the forward tile points "
          f"{cas.FWD_POINTS}: worst {share_t:.3f} of its tolerance",
          flush=True)

    # the tensor-core K1 and K2 with each design choice flipped (the
    # 64-map study's k1_mma and k2_mma points) at church64's 64 map, bf16,
    # against the plain versions
    _, b, n, m = STUDY_SITES[0]
    q, k, v, g = _bwd_inputs(gen, b, n, m, 2, 8, torch.bfloat16)
    want_o = attention_reference(q, k, v)
    want_g = attention_bwd_reference(q, k, v, g)
    flips = {}
    for kind, points, defines in (
            ("K1", cas.K1_MMA_POINTS, cas.K1_MMA_DEFINES),
            ("K2", cas.K2_MMA_POINTS, cas.K2_MMA_DEFINES)):
        for point in points:
            if kind == "K1":
                share = _grad_errors(
                    (cuda_attention.attention_fused(q, k, v, defines[point],
                                                    "mma"),),
                    (want_o,), TOL[torch.bfloat16])[0]
            else:
                share = _grad_errors(cuda_attention.attention_bwd_fused(
                    q, k, v, g, defines[point], "mma"), want_g,
                    BWD_TOL[torch.bfloat16])[0]
            flips[f"{kind} {point[0]}"] = share
            require(share <= 1, f"{kind} (mma) {point[0]} at the 64 map: "
                                f"{share:.3f} of its tolerance")
    del q, k, v, g, want_o, want_g
    print(f"phase 20 the tensor-core K1 and K2 at each design flip, 64 map "
          f"B={b} bf16, share of the tolerance: "
          f"{', '.join(f'{key} {x:.3f}' for key, x in flips.items())}",
          flush=True)

    # the tensor-core K4 + K5 with each design choice flipped (the
    # backward studies' k45_mma points), and the tensor-core K6 at each
    # (query tile, key block) point (their k6_mma points), bf16, against
    # the plain backward at K4-K6's tile site and at two ragged shapes (N
    # and M off every tile; M under one key block, and M past two); each
    # K6 point also against the shipped K4 + K5, its partials sized by
    # its own library, and the K2, K4 and K5 of its library equal to the
    # shipped ones bit for bit (the K6 defines leave them as they are)
    flips, k6_points = {}, {}
    bf16_tol = BWD_TOL[torch.bfloat16]
    for b, n, m in (STUDY_BWD_SITE[:3], FLASH_RAGGED[0], FLASH_RAGGED[2]):
        q, k, v, g = _bwd_inputs(gen, b, n, m, 2, 8, torch.bfloat16)
        o, lse = cuda_attention.attention_flash_fwd(q, k, v)
        args = (q, k, v, o, lse, g)
        want = attention_flash_bwd_reference(*args, plain_chunk(b, n, m))
        shipped = cuda_attention.attention_flash_dq_dkv(*args, engine="mma")
        for point in cas.K45_MMA_POINTS:
            got = cuda_attention.attention_flash_dq_dkv(
                *args, cas.K45_MMA_DEFINES[point], "mma")
            share = _grad_errors(got, want, bf16_tol)[0]
            same = all(torch.equal(x, y) for x, y in zip(got, shipped))
            flips[f"{point[0]} B={b} N={n} M={m}"] = (share, same)
            require(share <= 1, f"K4 + K5 (mma) {point[0]} at B={b} N={n} "
                                f"M={m}: {share:.3f} of its tolerance")
        k2 = cuda_attention.attention_bwd_fused(q, k, v, g, engine="mma")
        default = cuda_attention.attention_flash_dqkv(*args)
        for point, tiles in cas.K6_MMA_DEFINES.items():
            got = cuda_attention.attention_flash_dqkv(*args, tiles, "mma")
            share = max(_grad_errors(got, want, bf16_tol)[0],
                        _grad_errors(got, shipped, bf16_tol)[0])
            keys = cuda_attention.keys_per_block(2, 8, tiles)
            part = cuda_attention.dq_partial_shape(b, n, m, 2, 8, tiles,
                                                   "mma")
            same = all(torch.equal(x, y) for x, y in zip(
                cuda_attention.attention_flash_dq_dkv(*args, tiles, "mma"),
                shipped)) and all(torch.equal(x, y) for x, y in zip(
                    cuda_attention.attention_bwd_fused(q, k, v, g, tiles,
                                                       "mma"), k2))
            if not tiles:
                same = same and all(torch.equal(x, y)
                                    for x, y in zip(got, default))
            k6_points[point[0]] = (
                max(share, k6_points.get(point[0], (0.0,))[0]), keys)
            require(share <= 1, f"K6 (mma) {point[0]} at B={b} N={n} M={m}: "
                                f"{share:.3f} of its tolerance")
            require(keys in (512, 1024, 2048, 4096)
                    and part == (b, -(-m // keys), n, 2),
                    f"K6 (mma) {point[0]}: {keys} keys a block, partials "
                    f"{part}")
            require(same, f"K6 (mma) {point[0]}'s library: K2, K4 or K5 "
                          f"not the shipped bits at B={b} N={n} M={m}")
    del q, k, v, g, o, lse, args, want, shipped, got, k2, default
    print(f"phase 20 the tensor-core K4 + K5 at each design flip, bf16, "
          f"share of the tolerance (bitwise equal to the shipped pair): "
          + ", ".join(f"{key} {x:.3f} ({same})"
                      for key, (x, same) in flips.items()), flush=True)
    print(f"phase 20 the tensor-core K6 at each (query tile, key block) "
          f"point vs the plain backward and K4 + K5 at B, N, M "
          f"{STUDY_BWD_SITE[:3]}, {FLASH_RAGGED[0]}, {FLASH_RAGGED[2]}, "
          f"bf16, worst share of the tolerance (keys a block): " + ", ".join(
              f"{name} {x:.3f} ({keys})"
              for name, (x, keys) in k6_points.items())
          + "; the K2, K4 and K5 of every point's library and the shipped "
            "point's K6 bit for bit the shipped ones", flush=True)
    heads["k6_points"] = {name: {"worst_share": x, "keys_per_block": keys}
                          for name, (x, keys) in k6_points.items()}

    # the CUDA-core K4, K5 and K6 at every backward tile point vs K4 + K5
    # at the shipped tiles, each output
    b, n, m, d, c = STUDY_BWD_SITE
    share_b = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = _bwd_inputs(gen, b, n, m, d, c, dtype)
        o, lse = cuda_attention.attention_flash_fwd(q, k, v)
        args = (q, k, v, o, lse, g)
        want = cuda_attention.attention_flash_dq_dkv(*args, (), "fma")
        tol = _study_tol(dtype)
        for point in cas.BWD_POINTS:
            tiles = cas.bwd_tiles(point)
            got = {"K4": (cuda_attention.attention_flash_dq(*args, tiles,
                                                            "fma"),),
                   "K5": cuda_attention.attention_flash_dkv(*args, tiles,
                                                            "fma"),
                   "K6": cuda_attention.attention_flash_dqkv(*args, tiles,
                                                             "fma")}
            for kernel, outs in got.items():
                ref = want[:1] if kernel == "K4" else (
                    want[1:] if kernel == "K5" else want)
                share = _grad_errors(outs, ref, tol)[0]
                key = (kernel, str(dtype).removeprefix("torch."))
                share_b[key] = max(share_b.get(key, 0.0), share)
                require(share <= 1, f"{kernel} at tiles {point} {dtype}: "
                        f"{share:.3f} of its tolerance")
    print(f"phase 20 K4, K5, K6 at the backward tile points "
          f"{cas.BWD_POINTS} vs K4 + K5 shipped, B={b} N={n} M={m}: worst "
          f"share of the tolerance " + ", ".join(
              f"{k} {t} {x:.3f}" for (k, t), x in share_b.items()),
          flush=True)
    return heads


def _study_rows(result: dict):
    for section, rows in result["sections"].items():
        for key, row in rows.items():
            yield f"{section}/{key}", row


def _unheld(result: dict, held: tuple) -> list:
    """The rows of a study's ``HELD`` sections (but their "best") that
    carry no max|Δ|."""
    return [name for name, row in _study_rows(result)
            if (name in held or name.split("/")[0] in held)
            and not name.endswith("/best") and "max_abs_err" not in row]


def phase_studies(card: str) -> dict:
    """Each study's ``main(["--quick"])`` in process: every section
    present, every time > 0, every max|Δ| within its limit (the studies
    hold what they time, at its full shape, against the plain versions on
    their check rows: ``tools._study.held``), and the study kernels
    launched.  Returns the study kernels' launches."""
    cas = cuda_attention_study
    cas.STUDY_LAUNCHES = cas.FOLDED_LAUNCHES = 0
    for study in (bench_attn_floor, bench_attn_floor256, bench_attn_bwd256,
                  bench_attn_floor512):
        t0 = time.perf_counter()
        result = study.main(["--quick"])
        missing = set(study.SECTIONS) - set(result["sections"])
        require(not missing, f"{result['study']} lacks {missing}")
        unheld = _unheld(result, study.HELD)
        require(not unheld, f"{result['study']}: no max|Δ| in {unheld}")
        times, errors = 0, 0
        for name, row in _study_rows(result):
            for key, x in row.items():
                if key.endswith("ms") and x is not None:
                    require(x > 0, f"{result['study']} {name} {key} {x}")
                    times += 1
            errs, limits = row.get("max_abs_err"), row.get("limit")
            if errs is not None:
                errors += 1
                pairs = zip(errs, limits) if isinstance(errs, list) \
                    else [(errs, limits)]
                require(all(e <= lim for e, lim in pairs),
                        f"{result['study']} {name}: {errs} past {limits}")
            require(row.get("ok", True), f"{result['study']} {name} failed")
        print(f"phase 21 {result['study']} --quick: sections "
              f"{list(result['sections'])}, {times} times > 0, "
              f"{errors} rows' max|Δ| each within its limit, "
              f"{time.perf_counter() - t0:.0f} s "
              f"on {card}", flush=True)
    launches = {"attention_study": cas.STUDY_LAUNCHES,
                "attention_folded": cas.FOLDED_LAUNCHES}
    print(f"phase 21 study kernel launches: {launches}", flush=True)
    require(all(launches.values()), f"a study kernel never ran: {launches}")
    return launches

# phase 22: the streaming buffer of the church64 feed, the shards that the
# decode workers split, and the image folder
FEED_SHUFFLE = 512
DECODE_SHARDS = 8
FOLDER_IMAGES = 256


def _church64_file(path: Path, data: Path, epochs: int, **extra) -> Path:
    """A copy of the church64 config on ``data`` for ``epochs`` epochs,
    with ``extra`` keys (no summaries, sample grids or checkpoints unless
    they say so)."""
    extra = {"data_path": str(data), "epoch": epochs, "log_dir": None,
             "img_dir": None, "ckpt_dir": None, "print_variables": False,
             **extra}
    path.write_text(f"import runpy\n"
                    f"config = dict(runpy.run_path({str(CONFIG)!r})"
                    f"['config'])\n"
                    f"config.update({extra!r})\n")
    return path


def _first_calls(recorded: dict, steps_per_epoch: int):
    """``TrainStep.__call__`` keeping (images, labels) of each epoch's
    first call, by epoch, on the host."""
    call = TrainStep.__call__

    def recording(self, state, images_k, labels_k, latents_k=None):
        if state.step % steps_per_epoch == 0:
            recorded[state.step // steps_per_epoch] = (images_k.cpu(),
                                                       labels_k.cpu())
        return call(self, state, images_k, labels_k, latents_k)

    return recording


def phase_feeds(card: str) -> None:
    """The church64 feeds at full width on phase 7's 2,048 synthetic
    records: (a) the CLI on the host feed (``device_cache: False``) for 2
    epochs, then under the default ``device_cache: "auto"`` (the dataset
    on the card, index batches) for 2 epochs and a restart for a 3rd, the
    first call of each epoch gathered on the card equal byte for byte to
    the host feed's; (b) one streaming epoch (``cache_dataset: False``,
    ``shuffle_buffer`` 512) through the native reader equal to the
    pure-Python reader's, with both decode rates; (c) the image folder
    (``use_image_generator``) of 256 generated 64 px PNGs in two class
    folders, trained through the tensor-core K1 and K2."""
    smoke = ROOT / "build" / "smoke"
    data = smoke / "church64_synthetic"
    if not (data / "metadata.pickle").exists():
        make_synthetic_dataset(str(data), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED)
    shutil.rmtree(smoke / "ckpt_feeds", ignore_errors=True)
    steps_per_epoch = SMOKE_RECORDS // 64

    # (a) the host feed, then the device cache and its restart
    host, text, counts, _, _ = _run_cli(
        _church64_file(smoke / "feeds_host.py", data, 2, device_cache=False),
        card, "22a host feed")
    steps = host.global_step()
    require(host._device_data is None and "device cache" not in text
            and "feed=host/native" in text
            and counts == _launches(K1mma=8 * steps, K2mma=6 * steps),
            f"the host-feed run: {counts} for {steps} steps, or a device "
            f"cache / another reader")
    want = {e: next(host._device_batches(e)) for e in range(3)}
    recorded = {}
    call = TrainStep.__call__
    TrainStep.__call__ = _first_calls(recorded, steps_per_epoch)
    try:
        texts = []
        for epochs in (2, 3):
            trainer, text, counts, _, _ = _run_cli(
                _church64_file(smoke / f"feeds_cache_e{epochs}.py", data,
                               epochs, ckpt_dir=str(smoke / "ckpt_feeds")),
                card, f"22a device cache {'run' if epochs == 2 else 'restart'}")
            texts.append(text)
            steps = (2 if epochs == 2 else 1) * steps_per_epoch
            require(counts == _launches(K1mma=8 * steps, K2mma=6 * steps),
                    f"device-cache run: launches {counts} for {steps} steps")
    finally:
        TrainStep.__call__ = call
    lines = [line for text in texts for line in text.splitlines()
             if line.startswith("device cache:")]
    same = {e: torch.equal(recorded[e][0], want[e][0].cpu())
            and torch.equal(recorded[e][1], want[e][1].cpu())
            for e in range(3)}
    restored = f"Restored from checkpoint at step {2 * steps_per_epoch}"
    print(f"phase 22a: {lines}; each epoch's first call "
          f"({tuple(want[0][0].shape)} uint8) gathered on the card against "
          f"the host feed's, byte for byte: {same}; the restart: "
          f"{restored in texts[1]} on {card}", flush=True)
    require(len(lines) == 2 and all(same.values()) and restored in texts[1]
            and all("feed=device-cache/native" in t for t in texts),
            "the device cache did not give the host feed's batches")

    # (b) one streaming epoch through each reader, and the decode rates
    # of both readers at data_workers 1 and 4 over the records in 8 shards
    sharded = smoke / "church64_sharded"
    if not (sharded / "metadata.pickle").exists():
        make_synthetic_dataset(str(sharded), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED,
                               num_shards=DECODE_SHARDS)
    batches, rates = {}, {}
    for native in (True, False):
        for workers in (1, 4):
            t0 = time.perf_counter()
            n = len(ImageDataset(str(sharded), 64, num_workers=workers,
                                 use_native=native).materialized()[1])
            rates[native, workers] = n / (time.perf_counter() - t0)
        ds = ImageDataset(str(data), 64, cache_in_memory=False,
                          shuffle_buffer=FEED_SHUFFLE, use_native=native)
        batches[native] = list(ds.epoch(0))
        require(ds.reader == ("native" if native else "python"), ds.reader)
    same = len(batches[True]) == len(batches[False]) == steps_per_epoch and \
        all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(batches[True], batches[False]))
    print(f"phase 22b streaming epoch (shuffle_buffer {FEED_SHUFFLE}, "
          f"{len(batches[True])} batches of 64): native reader vs "
          f"pure-Python reader byte for byte: {same}; decode (host "
          f"clock, {SMOKE_RECORDS} 64 px records in {DECODE_SHARDS} shards, "
          f"crc checked) records/s at data_workers 1 / 4: native "
          f"{rates[True, 1]:.0f} / {rates[True, 4]:.0f}, Python "
          f"{rates[False, 1]:.0f} / {rates[False, 4]:.0f} on the host of "
          f"{card}", flush=True)
    require(same, "the native reader's streaming epoch differs from the "
                  "pure-Python reader's")

    # (c) the image folder
    from PIL import Image

    folder = smoke / "church64_folder"
    if not folder.exists():
        for i, (img, label) in enumerate(synthetic_images(
                FOLDER_IMAGES, 64, 2, seed=SEED)):
            (folder / f"class{label}").mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(folder / f"class{label}" / f"{i}.png")
    trainer, text, counts, _, _ = _run_cli(
        _church64_file(smoke / "feeds_folder.py", folder, 1,
                       use_image_generator=True, img_size=64,
                       steps_per_call=4),
        card, "22c image folder")
    steps = trainer.global_step()
    print(f"phase 22c image folder: {trainer.config['num_classes']} classes, "
          f"{steps} steps; launches {counts}", flush=True)
    require(steps == FOLDER_IMAGES // 64 and "device cache" not in text
            and "feed=host/PIL" in text
            and trainer.config["num_classes"] == 2
            and counts == _launches(K1mma=8 * steps, K2mma=6 * steps),
            f"the image-folder run: {steps} steps, launches {counts}")


# phase 23: remat against no remat, one church512 step at B = 8 in bf16.
# The same operations on the same values, but a cuDNN or cuBLAS algorithm
# may sum in another order between two steps (and picks by the memory
# free): losses and gradient norms within REMAT_RTOL (a few bf16
# roundings), u and the BN running stats within REMAT_ATOL
REMAT_RTOL = 2e-2
REMAT_ATOL = 1e-3


def _step_state(config, gen0, disc0, remat: bool):
    gen, disc = copy.deepcopy(gen0), copy.deepcopy(disc0)
    gen.remat = disc.remat = remat
    gen.to("cuda").train()
    disc.to("cuda").train()
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        config, gen.parameters(), disc.parameters(), steps_per_epoch=1)
    state = TrainState(gen, disc, opt_g, opt_d, 0, None)
    return state, build_train_step(config, sched_g, sched_d, gen, disc)


def _timed_steps(step, state, images, labels, n: int) -> tuple:
    """(median device ms of ``n`` steps between CUDA events, peak memory
    GiB over them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, images, labels)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2 ** 30


def _rel_norms(got, want) -> float:
    """Largest |got - want| of per-variable gradient norms over
    max(|want|, 1e-3 max|want|)."""
    floor = 1e-3 * want.abs().max()
    return ((got - want).abs() / torch.maximum(want.abs(), floor)).max().item()


def phase_remat512(card: str) -> None:
    """One church512 training step at B = 8 in bf16 from the same state and
    latents without remat, with ``remat: True`` and without again: losses,
    gradient norms, u and BN running stats against the first; launches,
    device ms and peak memory of each (two more steps timed).  Under remat
    the stages' attention runs again in the backward: K1 twice more (D's
    stage in D's and G's backward), K3 once more (G's 512 stage)."""
    config = church512_config("bfloat16")
    config.update(batch_size=8, global_batch_size=8)
    gen0, disc0 = _church512_nets(config, SEED + 80)
    rng = torch.Generator("cuda").manual_seed(SEED + 81)
    images = torch.randint(0, 256, (1, 8, 512, 512, 3), dtype=torch.uint8,
                           device="cuda", generator=rng)
    labels = torch.zeros(1, 8, dtype=torch.int32, device="cuda")
    runs = []
    for remat in (False, True, False):
        state, step = _step_state(config, gen0, disc0, remat)
        _zero_counts()               # the step starts here
        m = step(state, images, labels)
        torch.cuda.synchronize()
        counts = _counts()           # and ends here
        bufs = {f"{tag}.{k}": v.float().cpu()
                for tag, net in (("G", state.gen), ("D", state.disc))
                for k, v in net.named_buffers()}
        ms, peak = _timed_steps(step, state, images, labels, 2)
        runs.append(({k: v.detach().float().cpu() for k, v in m.items()},
                     bufs, counts, ms, peak))
        del state, step
        torch.cuda.empty_cache()
    want_m, want_b = runs[0][:2]
    for (m, bufs, counts, ms, peak), remat in zip(runs, ("off", "on", "off")):
        loss = max(abs(float(m[k]) - float(want_m[k])) /
                   abs(float(want_m[k])) for k in ("G_loss", "D_loss",
                                                   "G_grad_norm",
                                                   "D_grad_norm"))
        norms = max(_rel_norms(m[k], want_m[k])
                    for k in ("G_grad_norms", "D_grad_norms"))
        buf = max((bufs[k] - v).abs().max().item()
                  for k, v in want_b.items())
        print(f"phase 23 church512 B=8 bf16 remat {remat}: losses "
              f"{float(m['G_loss']):.6f} / {float(m['D_loss']):.6f}, worst "
              f"rel err against the first run: losses and global norms "
              f"{loss:.3g}, per-variable gradient norms {norms:.3g} (tol "
              f"{REMAT_RTOL:g}), u and BN stats max abs {buf:.3g} (tol "
              f"{REMAT_ATOL:g}); launches {counts}; {ms:.3f} device ms a "
              f"step (median of 2, CUDA events), peak memory {peak:.2f} GiB "
              f"on {card}", flush=True)
        require(loss <= REMAT_RTOL and norms <= REMAT_RTOL
                and buf <= REMAT_ATOL, f"remat {remat} disagrees")
    plain = _launches(K1mma=2, K2mma=2, K3mma=2, K6mma=1)
    require(runs[0][2] == runs[2][2] == plain
            and runs[1][2] == _launches(K1mma=4, K2mma=2, K3mma=3, K6mma=1),
            f"launches without remat {runs[0][2]}, with {runs[1][2]}")

    # grad_accum_steps 2: micro-batches of 4, whose fp32 dq partials fit
    # the slab budget as the whole batch's do, so each micro backward of G
    # takes K6 too (the route goes by the call's shape)
    state, step = _step_state(dict(config, grad_accum_steps=2), gen0, disc0,
                              False)
    _zero_counts()
    m = step(state, images, labels)
    torch.cuda.synchronize()
    counts = _counts()
    ms, peak = _timed_steps(step, state, images, labels, 2)
    losses = {k: float(m[k]) for k in ("G_loss", "D_loss")}
    want = _launches(K1mma=4, K2mma=4, K3mma=4, K6mma=2)
    print(f"phase 23 church512 B=8 bf16 grad_accum_steps 2 (micro-batches "
          f"of 4): losses {losses}; launches {counts} (expected {want}: K6 "
          f"for each micro backward of G, in the slab budget); {ms:.3f} "
          f"device ms a step, peak memory {peak:.2f} GiB on {card}",
          flush=True)
    require(all(math.isfinite(x) for x in losses.values())
            and counts == want, f"accumulated B=8 step: {counts}, {losses}")


# phase 24: gradient accumulation at imagenet128_cond's full width, bf16.
# The accumulated G gradient against the mean of the micro-batch gradients
# taken one at a time from a copy of the nets: the same operations, but
# cuDNN's backward may sum in another order and round to bf16 (a few ulp
# of 2^-8): each tensor within ACCUM_TOL of its largest value.  The
# finalized BN stats against the momentum update of the micro-batches'
# averaged moments, the same fp32 arithmetic: within 1e-4 (x max(1, |v|)).
ACCUM_BATCH, ACCUM_STEPS = 256, 4
ACCUM_TOL = 1e-2
ACCUM_BN_TOL = 1e-4


def _moment_hooks(bns) -> tuple:
    """Forward pre-hooks on ``bns`` keeping each call's fp32 (E[x],
    E[x²]); returns (the moments by layer, the hook handles)."""
    moments = {bn: [] for bn in bns}

    def hook(bn, args):
        x = args[0].float()
        moments[bn].append((x.mean(dim=(0, 2, 3)),
                            x.square().mean(dim=(0, 2, 3))))

    return moments, [bn.register_forward_pre_hook(hook) for bn in bns]


def _check_accumulation(step, state, captured, latents, accum: int) -> None:
    """The G update's accumulation (``captured``: copies of G and D as it
    began, the mean gradients it returned) against its micro-batches run
    one at a time on the copies, and G's finalized BN stats (``state``)
    against the momentum update of their averaged moments."""
    (gen, disc), got = captured
    bns = layers.bn_moment_paths(gen)
    old = [(bn.mean.clone(), bn.var.clone()) for bn in bns]
    moments, handles = _moment_hooks(bns)
    z, fake_labels = latents
    micro = z.shape[0] // accum
    total = None
    for a in range(accum):
        sl = slice(a * micro, (a + 1) * micro)
        loss = step.gloss_fn(disc(gen(z[sl], fake_labels[sl]),
                                  fake_labels[sl]))
        grads = torch.autograd.grad(loss, list(gen.parameters()))
        total = grads if total is None else [t + g for t, g in
                                             zip(total, grads)]
    for h in handles:
        h.remove()
    grad_err = max(_rel(g, t / accum) for g, t in zip(got, total))
    m = layers.BN_MOMENTUM
    bn_err = 0.0
    for bn, live, (old_mean, old_var) in zip(
            bns, layers.bn_moment_paths(state.gen), old):
        mean = sum(x for x, _ in moments[bn]) / accum
        var = torch.clamp(sum(y for _, y in moments[bn]) / accum
                          - mean.square(), min=0.0)
        for got_s, want_s in ((live.mean, m * old_mean + (1 - m) * mean),
                              (live.var, m * old_var + (1 - m) * var)):
            bn_err = max(bn_err, ((got_s - want_s).abs()
                                  / want_s.abs().clamp_min(1.0)).max().item())
    print(f"phase 24 accumulated G gradients ({len(got)} tensors) vs the mean "
          f"of {accum} micro-batch gradients taken one at a time: worst err "
          f"/ max|v| {grad_err:.3g} (tol {ACCUM_TOL:g}); finalized BN stats "
          f"of {len(bns)} layers vs the momentum update of the averaged "
          f"moments: {bn_err:.3g} (tol {ACCUM_BN_TOL:g})", flush=True)
    require(grad_err <= ACCUM_TOL and bn_err <= ACCUM_BN_TOL
            and all(len(v) == accum for v in moments.values()),
            "the accumulated step disagrees with its micro-batches")


def phase_accum128(card: str) -> None:
    """imagenet128_cond (``use_pallas_sn``, bf16) at batch 256 with
    ``grad_accum_steps`` 4 (micro-batches of 64): the G update's
    accumulated gradients against the mean of the four micro-batch
    gradients taken one at a time, the finalized BN stats against the
    momentum update of the averaged moments; launches 4x those of a
    batch-64 step; peak memory and device ms a step beside batch 64
    without accumulation."""
    out = {}
    for batch, accum in ((64, 1), (ACCUM_BATCH, ACCUM_STEPS)):
        config = imagenet_config(IMAGENET128, "bfloat16", use_pallas_sn=True,
                                 batch_size=batch, global_batch_size=batch,
                                 grad_accum_steps=accum)
        gen = get_generator(config,
                            rng=torch.Generator().manual_seed(SEED + 90))
        disc = get_discriminator(config,
                                 rng=torch.Generator().manual_seed(SEED + 91))
        state, step = _step_state(config, gen, disc, False)
        rng = torch.Generator("cuda").manual_seed(SEED + 92)
        images = torch.randint(0, 256, (1, batch, 128, 128, 3),
                               dtype=torch.uint8, device="cuda", generator=rng)
        labels = torch.randint(0, 1000, (1, batch), dtype=torch.int32,
                               device="cuda", generator=rng)
        lat = step.latents(0, batch, "cuda")
        captured = []
        accumulated = TrainStep._accumulated

        def spy(self, nets, micro_step, micro):
            snapshot = [copy.deepcopy(net) for net in nets]
            result = accumulated(self, nets, micro_step, micro)
            captured.append((snapshot, [g.clone() for g in result[1]]))
            return result

        if accum > 1:
            TrainStep._accumulated = spy
        try:
            _zero_counts()           # the step starts here
            step(state, images, labels, [lat])
            torch.cuda.synchronize()
            counts = _counts()       # and ends here
        finally:
            TrainStep._accumulated = accumulated
        if accum > 1:
            _check_accumulation(step, state, captured[-1], lat["g"], accum)
        del captured
        ms, peak = _timed_steps(step, state, images, labels, 3)
        out[accum] = counts, ms, peak
        print(f"phase 24 imagenet128_cond bf16 use_pallas_sn batch {batch} "
              f"grad_accum_steps {accum}: {ms:.3f} device ms a step (median "
              f"of 3, CUDA events, host dispatch included), peak memory "
              f"{peak:.2f} GiB; launches {counts} on {card}", flush=True)
    one = _launches(K1mma=12, K2mma=8, K7=SN_CALLS_PER_STEP, K7w=SN_PER_STEP,
                    K7bwd=SN_BWD_PER_STEP)
    require(out[1][0] == one
            and out[ACCUM_STEPS][0] == {k: ACCUM_STEPS * v
                                        for k, v in one.items()},
            f"launches: batch 64 {out[1][0]} (expected {one}), accumulated "
            f"{out[ACCUM_STEPS][0]} (expected {ACCUM_STEPS}x)")


# phase 25: evaluation.  The proxy and InceptionV3 on the card against the
# CPU: the same fp32 operations (TF32 off) summed in other orders, within
# EVAL_TOL of the largest |value|
EVAL_TOL = 1e-4
EVAL_IMAGES = 5000          # church64's fid_num_images
EVAL_BATCH = 64
INCEPTION_IMAGES = 256      # the evaluate CLI on the random-weights npz
IMAGENET_EVAL_IMAGES = 512  # the evaluate CLI on phase 16's checkpoint


@contextlib.contextmanager
def _eval_spy(record: dict):
    """While open: the FID epoch's host seconds (``Trainer._evaluate``,
    synchronised) and launches, the real and fake statistics' seconds
    (``fid.real_stats``, ``fid.fake_stats``: each ends in a copy to the
    host), and the forwards of every evaluation G (a forward hook on what
    ``eval_generator`` returns) into ``record``."""
    from sagan_tpu_torch.train import fid as fid_module

    evaluate_epoch = Trainer._evaluate
    eval_generator = Trainer.eval_generator
    stats = {"real_stats": fid_module.real_stats,
             "fake_stats": fid_module.fake_stats}
    record.setdefault("forwards", 0)

    def timed_epoch(self, epoch, step):
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        evaluate_epoch(self, epoch, step)
        torch.cuda.synchronize()
        record["epoch_s"] = time.perf_counter() - t0
        record["epoch_counts"] = {k: v - before[k]
                                  for k, v in _counts().items()}

    def hooked(self):
        gen = eval_generator(self)
        if not getattr(gen, "_smoke_hooked", False):
            gen.register_forward_hook(
                lambda *_: record.__setitem__("forwards",
                                              record["forwards"] + 1))
            gen._smoke_hooked = True
        return gen

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            record[name + "_s"] = time.perf_counter() - t0
            return out
        return run

    Trainer._evaluate = timed_epoch
    Trainer.eval_generator = hooked
    for name, fn in stats.items():
        setattr(fid_module, name, timed(name, fn))
    try:
        yield record
    finally:
        Trainer._evaluate = evaluate_epoch
        Trainer.eval_generator = eval_generator
        for name, fn in stats.items():
            setattr(fid_module, name, fn)


# the launch counters by the kernels' names in tools/profiling.py
PROFILE_NAMES = {"K1": "K1 attention_fwd", "K1mma": "K1 attention_fwd_mma",
                 "K2": "K2 attention_bwd", "K2mma": "K2 attention_bwd_mma",
                 "K3": "K3 attention_flash_fwd",
                 "K3mma": "K3 attention_flash_fwd_mma",
                 "K7": "K7 spectral_norm (grouped calls)",
                 "K7w": "K7 weights normalized",
                 "K7bwd": "K7 spectral_norm_bwd"}


def _named(counts: dict) -> dict:
    """The nonzero launch counts under tools/profiling.py's names."""
    return {PROFILE_NAMES.get(k, k): v for k, v in counts.items() if v}


def _trace_kernels(prof_dir: Path) -> dict:
    """Launches of the tensor-core K1 and K2 (the first kernel of each, by
    tools/profiling.py's names) and of all kernels in the one trace under
    ``prof_dir``."""
    from sagan_tpu_torch.tools.profiling import ATTENTION_KERNELS

    (trace,) = prof_dir.glob("*.pt.trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    first = {label: kernels[0] for label, kernels in ATTENTION_KERNELS}
    return {key: sum(first[PROFILE_NAMES[key]] in n for n in names)
            for key in ("K1mma", "K2mma")} | {"all": len(names)}


def _tags(log_dir: Path) -> set:
    """The tags of every summary value in the event files of ``log_dir``."""
    from sagan_tpu_torch.data.tfrecord import _iter_fields, read_records

    tags = set()
    for path in log_dir.glob("events.out.tfevents.*"):
        for rec in read_records(str(path)):
            for field, _, summary in _iter_fields(memoryview(rec)):
                if field != 5:
                    continue
                for _, _, value in _iter_fields(summary):
                    tags.update(bytes(v).decode()
                                for f, _, v in _iter_fields(value) if f == 1)
    return tags


def _evaluate_cli(argv: list, record: dict) -> dict:
    """``python -m sagan_tpu_torch.evaluate`` in this process on the card;
    its JSON line, printed; launches and G forwards into ``record``."""
    from sagan_tpu_torch import evaluate

    out = io.StringIO()
    with _eval_spy(record):
        _zero_counts()               # the evaluation starts here
        with contextlib.redirect_stdout(out):
            result = evaluate.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        record["counts"] = _counts()  # and ends here
    line = out.getvalue().strip().splitlines()[-1]
    require(json.loads(line) == result, line)
    return result


def _max_rel(got, want) -> float:
    return ((got.cpu() - want).abs().max() / want.abs().max()).item()


def phase_evaluate(card: str) -> None:
    """Evaluation on the card: (a) church64 at full width through the
    entry point for one epoch of 32 calls (``steps_per_call`` 1) on phase
    7's records with an FID epoch (5,000 images, proxy FID and IS), the
    profiler window over calls [10, 20) and weight histograms; (b)
    ``evaluate`` on its checkpoint with and without ``--raw_g`` (below
    ``g_ema_start`` the EMA is a copy of G: equal FIDs); (c) the proxy
    extractor and classifier on the card against the CPU; (d) InceptionV3
    at full width (299 px, 2048 features) on a random-weights npz against
    the CPU, timed, and ``evaluate`` through it; (e) ``evaluate`` on phase
    16's imagenet128_cond checkpoint (``use_pallas_sn``)."""
    from sagan_tpu_torch.train.fid import get_extractor
    from sagan_tpu_torch.train.inception import (InceptionV3Classifier,
                                                 InceptionV3Features,
                                                 write_random_weights_npz)
    from sagan_tpu_torch.train.iscore import get_classifier

    smoke = ROOT / "build" / "smoke"
    data = smoke / "church64_synthetic"
    if not (data / "metadata.pickle").exists():
        make_synthetic_dataset(str(data), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED)
    for sub in ("ckpt25", "logs25", "prof25"):
        shutil.rmtree(smoke / sub, ignore_errors=True)
    name = "chip_smoke_church64"
    for stale in Path(".cache").glob(f"{name}_*"):   # the real statistics
        stale.unlink()
    config_file = _church64_file(
        smoke / "evaluate25.py", data, 1, dataset=name, steps_per_call=1,
        fid_epoch_freq=1, fid_num_images=EVAL_IMAGES, inception_score=True,
        profile_dir=str(smoke / "prof25"), summary_histograms=True,
        log_dir=str(smoke / "logs25"), ckpt_dir=str(smoke / "ckpt25"))

    # (a) one epoch with an FID epoch
    record = {}
    with _eval_spy(record):
        trainer, text, counts, _, _ = _run_cli(config_file, card,
                                               "25a church64")
    steps = trainer.global_step()
    fid = re.search(r"^epoch 0: proxy_FID = (\S+)$", text, re.MULTILINE)
    iscore = re.search(r"^epoch 0: proxy_IS = (\S+) ± (\S+)$", text,
                       re.MULTILINE)
    forwards = record["forwards"]
    want_forwards = 2 * math.ceil(EVAL_IMAGES / EVAL_BATCH)
    want_epoch = _launches(K1mma=2 * forwards)
    want = _launches(K1mma=8 * steps + 2 * forwards, K2mma=6 * steps)
    fake_s = record["fake_stats_s"]
    print(f"phase 25a FID epoch: {record['epoch_s']:.3f} s (host clock, "
          f"synchronised): real statistics {record['real_stats_s']:.3f} s "
          f"({EVAL_IMAGES} records), fake statistics {fake_s:.3f} s "
          f"({EVAL_IMAGES / fake_s:.0f} "
          f"fake images/s, G forward and proxy features at B="
          f"{EVAL_BATCH}), the IS the rest; proxy_FID "
          f"{fid and fid.group(1)}, proxy_IS {iscore and iscore.group(1)} "
          f"± {iscore and iscore.group(2)}; {forwards} G forwards; the FID "
          f"epoch's launches {_named(record['epoch_counts'])} (K1 2 a G "
          f"forward), the run's {_named(counts)} on {card}", flush=True)
    require(steps == SMOKE_RECORDS // EVAL_BATCH and fid and iscore
            and math.isfinite(float(fid.group(1)))
            and float(fid.group(1)) > 0 and float(iscore.group(1)) >= 1.0
            and forwards == want_forwards
            and record["epoch_counts"] == want_epoch and counts == want,
            f"the FID epoch: {steps} steps, {forwards} forwards (expected "
            f"{want_forwards}), launches {record['epoch_counts']} (expected "
            f"{want_epoch}), the run's {counts} (expected {want})")
    window = _trace_kernels(smoke / "prof25")
    tags = _tags(smoke / "logs25")
    hists = sorted(t for t in tags if t.startswith("hist/"))
    print(f"phase 25a profiler window (calls [10, 20), steps_per_call 1): "
          f"{window['all']} kernels, K1 (tensor cores) {window['K1mma']}, "
          f"K2 {window['K2mma']}; event file: {len(hists)} hist/ "
          f"summaries, proxy_FID {'proxy_FID' in tags}, proxy_IS "
          f"{'proxy_IS' in tags}", flush=True)
    require(window["K1mma"] == 8 * 10 and window["K2mma"] == 6 * 10
            and len(hists) == len(list(trainer.state.gen.parameters()))
            + len(list(trainer.state.disc.parameters()))
            and {"proxy_FID", "proxy_IS"} <= tags,
            f"the trace or the event file: {window}, {len(hists)} hists")

    # (b) evaluate on the checkpoint, with and without --raw_g
    results = {}
    for flags in ([], ["--raw_g", "--no_is"]):
        record = {}
        result = _evaluate_cli(["--config_path", str(config_file)] + flags,
                               record)
        results[" ".join(flags) or "ema"] = result
        print(f"phase 25b evaluate {' '.join(flags)}: {json.dumps(result)}; "
              f"{record['forwards']} G forwards, launches "
              f"{_named(record['counts'])} on {card}", flush=True)
        require(record["counts"] == _launches(K1mma=2 * record["forwards"]),
                f"evaluate launched {record['counts']} for "
                f"{record['forwards']} forwards")
    ema, raw = results["ema"], results["--raw_g --no_is"]
    require(ema["ema"] and not raw["ema"] and ema["step"] == steps
            and ema["proxy_fid"] == raw["proxy_fid"]
            and ema["proxy_inception_score"] >= 1.0,
            f"below g_ema_start the EMA is G: {ema} vs {raw}")

    # (c) the proxy extractor and classifier, card against CPU
    imgs = torch.from_numpy(np.random.default_rng(SEED + 25).uniform(
        -1, 1, (256, 3, 64, 64)).astype(np.float32))
    errs = {}
    for kind, make in (("features", get_extractor),
                       ("probabilities", get_classifier)):
        cpu_net = make({"img_size": 64})
        with torch.inference_mode():
            want_v = cpu_net(imgs)
            got_v = make({"img_size": 64}, "cuda")(imgs.cuda())
        errs[kind] = _max_rel(got_v, want_v)
    print(f"phase 25c proxy on the card vs the CPU, 256 images at 64 px: "
          f"max|err| / max|v| features {errs['features']:.3g}, "
          f"probabilities {errs['probabilities']:.3g} (tol {EVAL_TOL:g})",
          flush=True)
    require(max(errs.values()) <= EVAL_TOL, f"the proxy on the card: {errs}")

    # (d) InceptionV3 at full width on random weights
    npz = smoke / "inception_random.npz"
    write_random_weights_npz(str(npz), seed=SEED)
    x = imgs[:EVAL_BATCH]
    errs = {}
    for kind, cls in (("features", InceptionV3Features),
                      ("probabilities", InceptionV3Classifier)):
        with torch.inference_mode():
            want_v = cls(str(npz))(x)
            net = cls(str(npz)).cuda()
            got_v = net(x.cuda())
        errs[kind] = _max_rel(got_v, want_v)
        if kind == "features":
            with torch.inference_mode():
                ms, _ = cuda_time_ms(net, x.cuda(), iters=5, reps=3,
                                     warmup=2)
    print(f"phase 25d InceptionV3 (299 px, 2048 features, random weights) "
          f"on the card vs the CPU, {EVAL_BATCH} images resized from 64 px: "
          f"max|err| / max|v| features {errs['features']:.3g}, "
          f"probabilities {errs['probabilities']:.3g} (tol {EVAL_TOL:g}); "
          f"{ms:.3f} ms per {EVAL_BATCH} images (CUDA events, median of 3 "
          f"means of 5 calls, fp32, TF32 off), "
          f"{EVAL_BATCH / ms * 1e3:.0f} images/s on {card}", flush=True)
    require(max(errs.values()) <= EVAL_TOL, f"InceptionV3 on the card: {errs}")
    inception_file = smoke / "evaluate25_inception.py"
    inception_file.write_text(
        config_file.read_text() + f"config.update(fid_extractor="
        f"'inception', inception_weights={str(npz)!r})\n")
    record = {}
    result = _evaluate_cli(["--config_path", str(inception_file),
                            "--num_images", str(INCEPTION_IMAGES)], record)
    print(f"phase 25d evaluate with fid_extractor 'inception' (random "
          f"weights: not a published-scale number): {json.dumps(result)}",
          flush=True)
    require(result["extractor"] == result["is_classifier"] == "inception"
            and math.isfinite(result["fid"])
            and result["inception_score"] >= 1.0,
            f"evaluate through InceptionV3: {result}")

    # (e) evaluate on phase 16's imagenet128_cond checkpoint
    imagenet_file = smoke / "imagenet128_smoke_e3.py"
    require(imagenet_file.exists(), "phase 25 needs phase 16's checkpoint")
    record = {}
    t0 = time.perf_counter()
    result = _evaluate_cli(["--config_path", str(imagenet_file),
                            "--num_images", str(IMAGENET_EVAL_IMAGES)],
                           record)
    seconds = time.perf_counter() - t0
    forwards = record["forwards"]
    want = _launches(K1mma=2 * forwards, K7=forwards,
                     K7w=SN_PER_G * forwards)
    print(f"phase 25e evaluate imagenet128_cond (use_pallas_sn) at "
          f"--num_images {IMAGENET_EVAL_IMAGES}: {json.dumps(result)}; "
          f"{seconds:.2f} s (host clock, with the Trainer's start-up); "
          f"{forwards} G forwards; launches {_named(record['counts'])} "
          f"(one grouped K7 call of {SN_PER_G} weights and K1 2 a forward) "
          f"on {card}", flush=True)
    require(forwards == 2 * IMAGENET_EVAL_IMAGES // EVAL_BATCH
            and record["counts"] == want
            and math.isfinite(result["proxy_fid"]),
            f"evaluate imagenet128_cond: {forwards} forwards, launches "
            f"{record['counts']} (expected {want})")


# -- phase 26: data parallelism ------------------------------------------------
DP_DIR = ROOT / "build" / "smoke" / "dp"
DP_TIMEOUT = 600          # seconds a group of ranks may take
# Two ranks at batch 64 against one process at 128 on the card are the same
# math in another summation order: each rank sums its 64 examples' weight
# gradients (cuDNN taking its algorithms at that batch) and the all-reduce
# adds the two.  The control, one process at 128 with the real images in
# reverse order (mathematically the same step: D has no batch-coupled
# layer), reads the card's own noise of a reordered sum.  Over several
# steps at the configs' learning rates that noise grows: Adam with
# beta1 = 0 moves an element whose gradient is ~0 by +-lr, and the next
# step's metrics follow such moves.  On an H100 80GB HBM3 at 700 W the
# control read up to 9.4e-4 relative on the losses and 1.2e-3 on the global
# gradient norms (imagenet128_cond fp32, 2 steps), 3.0e-5 on BN's running
# stats and 1.4e-4 on SN's u (of max(1, |value|)).  Those steps are held at
# 4x the control's worst: DP_FP32_RTOL on the losses and global norms,
# DP_FP32_BN_TOL and DP_FP32_U_TOL on the buffers, and the parameters and
# EMA within 3 lr_d.
DP_FP32_RTOL = 5e-3
DP_FP32_BN_TOL = 1.2e-4
DP_FP32_U_TOL = 6e-4
# The first step with D frozen (lr_d 0) has none of that noise: its G
# update takes its gradient before any parameter has moved, so every G
# gradient reaches the BN cotangent's all-reduce (mesh._MeanAllReduce)
# with only the reordered sums' rounding.  So its runs take cuDNN's
# deterministic algorithms, as phase 6's steps do: under the default ones
# the order of the atomic adds moved imagenet128_cond's G attn64.sigma
# gradient norm (the ranks against one process) from 0.26 to 1.59 of
# phase 6's limit over three runs, the reversed-images control from 0.26
# to 0.97; under the deterministic ones it reads 0.279 each run, and the
# control 0 (those algorithms sum the reversed batch to the same bits;
# on the card above).  Its losses and global gradient
# norms are held within DP_FROZEN_RTOL (on the card above, church64's read
# 1.3e-7 and imagenet128_cond's G norm 1.2e-5, past 1e-5), its
# per-variable norms within phase 6's per-norm limits, and the BN running
# stats and SN u after it within 1e-5 (of max(1, |value|)).  A planted
# fault, that backward returning its own rank's cotangent instead of the
# ranks' mean, moved church64's G norm by 2.2e-2 there: every fp32 check
# it runs under must fail.
DP_FROZEN_RTOL = 1e-4
DP_FROZEN_BUFFER_TOL = 1e-5
# bf16: losses and global gradient norms within 5e-2 relative (bf16 keeps
# 8 bits of mantissa, 3.9e-3 a rounding, compounding through G, D and the
# loss; two ranks normalize and reduce in another order than one process)
DP_BF16_RTOL = 5e-2
DP_STEP_KEYS = ("G_loss", "D_loss", "G_grad_norm", "D_grad_norm")
DP_BATCH = 64             # per rank: the configs' own per-device batch


def _dp_config(path: Path, dtype: str, **extra) -> dict:
    """A config file's dict at ``dtype``, not resolved: each process
    resolves it against its own group."""
    return {**load_config_file(str(path)), "compute_dtype": dtype,
            "num_devices": None, "print_variables": False, **extra}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _planted_bn_fault(on: bool):
    """While open (with ``on``): the cross-replica BN moments' backward
    returns this rank's own cotangent over the world size instead of the
    ranks' mean, so a rank's G gradient misses the other rank's BN
    terms."""
    backward = mesh._MeanAllReduce.backward
    if on:
        mesh._MeanAllReduce.backward = staticmethod(
            lambda ctx, grad: (grad / mesh.process_count(), None))
    try:
        yield
    finally:
        mesh._MeanAllReduce.backward = backward


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_steps(job: dict, device) -> dict:
    """A training step of seeded nets (every attention sigma nonzero) on
    this process's rows of each of the job's global batches,
    with the step's seeded latents (a rank takes its data index's rows of
    the global draws): the metrics, the whole state after (model-parallel
    shards gathered; and which entries are BN running stats and SN u),
    the launches, the seconds, the bytes the rank holds and its peak
    memory.  One process without a group takes the whole batch at
    model_parallel 1; under a group the job's ``model_parallel`` m makes
    a (W/m) x m grid."""
    device = torch.device(device)
    world = mesh.process_count()
    m = job.get("model_parallel", 1) if mesh.distributed() else 1
    cfg = resolve_config({**job["config"], "model_parallel": m,
                          "batch_size": job["global_batch"] * m // world})
    announced = io.StringIO()
    with contextlib.redirect_stdout(announced):
        model_parallel_routing(cfg, announce=mesh.process_index() == 0)
    mesh.make_grid(m)
    gen, disc = _church64_nets(cfg, job["seed"])
    gen, disc = gen.to(device), disc.to(device)
    axes_g, axes_d = sharding.shard_module(gen), sharding.shard_module(disc)
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        cfg, gen.parameters(), disc.parameters(), steps_per_epoch=1)
    state = TrainState(gen, disc, opt_g, opt_d, 0,
                       {n: p.detach().clone()
                        for n, p in gen.named_parameters()})
    step = build_train_step(cfg, sched_g, sched_d, gen, disc)
    rows = step.rows(cfg["batch_size"])
    if torch.is_tensor(rows):
        rows = rows.numpy()
    images = torch.from_numpy(job["images"][:, rows]).to(device)
    labels = torch.from_numpy(job["labels"][:, rows]).to(device)
    metrics = []
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _zero_counts()
    t0 = time.perf_counter()
    with _planted_bn_fault(job.get("fault", False)), \
            _planted_mp_fault(job.get("mp_fault")), \
            (_deterministic_cudnn() if job.get("frozen")
             else contextlib.nullcontext()):
        for k in range(len(images)):
            m_ = step(state, images[k:k + 1], labels[k:k + 1])
            metrics.append({key: m_[key].double().cpu().numpy()
                            for key in (*DP_STEP_KEYS, "G_grad_norms",
                                        "D_grad_norms")})
        _sync(device)
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    held = {"params": _nbytes([*gen.parameters(), *disc.parameters()]),
            "adam": _nbytes([v for opt in (opt_g, opt_d)
                             for st in opt.state.values()
                             for v in st.values()
                             if torch.is_tensor(v) and v.dim()]),
            "ema": _nbytes(state.ema.values())}
    after = {f"G/{k}": v.cpu() for k, v in
             sharding.whole(gen.state_dict(), axes_g).items()}
    after.update({f"D/{k}": v.cpu() for k, v in
                  sharding.whole(disc.state_dict(), axes_d).items()})
    after.update({f"EMA/{k}": v.cpu() for k, v in
                  sharding.whole(state.ema, axes_g).items()})
    buffers = {f"{tag}/{n}": ("SN u" if n.endswith(".u") or n == "u"
                              else "BN stats")
               for tag, net in (("G", gen), ("D", disc))
               for n, _ in net.named_buffers()}
    return {"metrics": metrics, "state": after, "buffers": buffers,
            "counts": counts, "seconds": seconds, "lr": cfg["lr_d"],
            "reduced": (sum(p.numel() for p in gen.parameters()),
                        sum(p.numel() for p in disc.parameters()),
                        cfg["update_ratio"]),
            "held": held, "peak": peak, "announced": announced.getvalue(),
            "sharded": len(axes_g) + len(axes_d),
            "names": (step.g_names, step.d_names)}


def rank_worker(jobs_path: str) -> int:
    """One rank of 26b's or 27's ``torch.distributed.run`` group: joins
    the group (the file's backend, on its device: ``cuda:0`` for every
    rank, sharing the card under gloo), runs the pickled step jobs in it,
    pickles their results to ``<jobs_path>.<rank>`` and leaves the
    group."""
    with open(jobs_path, "rb") as f:
        spec = pickle.load(f)   # written by phase 26 or 27 of this script
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh.initialize_distributed(
        spec["backend"], num_processes=int(os.environ["WORLD_SIZE"]),
        process_id=int(os.environ["RANK"]))
    try:
        results = [dp_steps(job, device) for job in spec["jobs"]]
    finally:
        mesh.shutdown_distributed()
    with open(f"{jobs_path}.{os.environ['RANK']}", "wb") as f:
        pickle.dump(results, f)
    return 0


def _launch(name: str, nproc: int, command: list) -> tuple:
    """``command`` (a script and its arguments, or ``-m`` and a module)
    on ``nproc`` ranks started by ``torch.distributed.run``, each rank's
    output in its own file: (each rank's standard output, the launcher's
    seconds)."""
    logs = DP_DIR / name
    shutil.rmtree(logs, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "--log-dir", str(logs),
         "--redirects", "3", *command], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0

    def read(rank: int, stream: str) -> str:
        paths = sorted(logs.glob(f"*/attempt_*/{rank}/{stream}.log"))
        return paths[-1].read_text() if paths else ""

    require(out.returncode == 0,
            f"the ranks of {name} failed (their logs in {logs}): "
            f"{out.stderr[-2000:]} rank 0: {read(0, 'stderr')[-3000:]}")
    return [read(rank, "stdout") for rank in range(nproc)], seconds


def _launch_ranks(jobs: list, name: str, nproc: int, backend: str,
                  device: str = "cuda:0") -> tuple:
    """Step ``jobs`` on ``nproc`` ranks (this script's rank worker) in one
    ``backend`` group on ``device``: (each rank's results, its
    seconds)."""
    DP_DIR.mkdir(parents=True, exist_ok=True)
    path = DP_DIR / f"{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump({"jobs": jobs, "backend": backend, "device": device}, f)
    _, seconds = _launch(name, nproc, [str(ROOT / "chip_smoke.py"),
                                       "--rank-jobs", str(path)])
    results = []
    for rank in range(nproc):
        with open(f"{path}.{rank}", "rb") as f:
            results.append(pickle.load(f))   # written by our own ranks
    return results, seconds


def _cli_rank(text: str) -> dict:
    """What one rank of ``sagan_tpu_torch.main`` printed: its last line's
    step and state digest, its total steps, whether it fed from the
    device cache, the step it restored, and the epoch lines' ms/step."""
    (last,) = re.findall(r"^rank \d+ of \d+: step (\d+) state (\w+)$", text,
                         re.MULTILINE)
    restored = re.findall(r"^Restored from checkpoint at step (\d+)$", text,
                          re.MULTILINE)
    return {"step": int(last[0]), "digest": last[1],
            "total": int(re.search(r"^total steps: (\d+)$", text,
                                   re.MULTILINE)[1]),
            "cache": "device cache: " in text,
            "restored": int(restored[0]) if restored else None,
            "ms": _ms_per_step(text)}


def dp_cli(argv: list) -> dict:
    """``sagan_tpu_torch.main`` with ``argv`` in this process (no group):
    its output, step, state digest, launches and parameter counts."""
    out = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        trainer = train_cli.main(argv)
    _sync(trainer.device)
    return {"text": out.getvalue(), "step": trainer.global_step(),
            "digest": train_cli.state_digest(trainer), "counts": _counts(),
            "params": (sum(p.numel() for p in trainer.state.gen.parameters()),
                       sum(p.numel() for p in trainer.state.disc.parameters()),
                       trainer.config["update_ratio"])}


def _ms_per_step(text: str) -> list:
    return [float(ms) for ms in re.findall(r"([\d.]+) ms/step\)$", text,
                                           re.MULTILINE)]


def _trace_all_reduces(prof_dir: Path) -> dict:
    """The all-reduces in the one trace under ``prof_dir``: {name: (count,
    ms)} of torch.distributed's host ops (``c10d::allreduce_``, host
    clock) and of the NCCL kernels (device clock)."""
    (trace,) = prof_dir.glob("*.pt.trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    found = {}
    for e in events:
        name, cat = e.get("name", ""), e.get("cat")
        if ((cat == "cpu_op" and name.startswith("c10d::allreduce"))
                or (cat == "kernel" and "nccl" in name.lower())):
            n, ms = found.get(name, (0, 0.0))
            found[name] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return found


def phase_dp_one_rank(card: str) -> None:
    """26a: church64 at full width (bf16, batch 64) through the entry
    point under ``torch.distributed.run --nproc_per_node 1`` (a one-rank
    NCCL group: every all-reduce runs) for 2 epochs of 20 steps on phase
    7's records, against the same run without a group: the state bit for
    bit, the launches unchanged (the tensor-core K1 8 and K2 6 a step:
    the group's in the profiler window of calls [10, 20), the other's
    counted), the second epoch's ms a step both ways (the first holds a
    new process's warm-up, NCCL's start and the window) and the
    all-reduces of the window's 10 steps from its trace."""
    data = ROOT / "build" / "smoke" / "church64_synthetic"
    if not (data / "metadata.pickle").exists():   # phase 7's records
        make_synthetic_dataset(str(data), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED)
    runs = {}
    for label in ("group", "alone"):
        prof = DP_DIR / f"prof_{label}"
        shutil.rmtree(prof, ignore_errors=True)
        cfg = _church64_file(DP_DIR / f"church64_dp_a_{label}.py", data, 2,
                             data_size=20 * DP_BATCH, steps_per_call=1,
                             profile_dir=str(prof))
        runs[label] = (["--config_path", str(cfg), "--device", "cuda"], prof)
    (text,), seconds = _launch("dp_a", 1, ["-m", "sagan_tpu_torch.main",
                                           *runs["group"][0]])
    ranked = _cli_rank(text)
    alone = dp_cli(runs["alone"][0])
    steps, window = alone["step"], 10
    traced = {label: _trace_kernels(prof) for label, (_, prof) in
              runs.items()}
    reduces = {label: _trace_all_reduces(prof) for label, (_, prof) in
               runs.items()}
    host_ops = sum(n for name, (n, _) in reduces["group"].items()
                   if name == "c10d::allreduce_")
    per_step = {name: (n / window, ms / window)
                for name, (n, ms) in reduces["group"].items()}
    g, d, ratio = alone["params"]
    want = _launches(K1mma=8 * steps, K2mma=6 * steps)
    same = ranked["digest"] == alone["digest"]
    print(f"phase 26a church64 bf16 B=64, {steps} steps (2 epochs of 20): "
          f"one-rank NCCL group vs no group: state digest "
          f"{'equal' if same else 'DIFFERENT'} ({ranked['digest'][:12]} / "
          f"{alone['digest'][:12]}); launches without the group "
          f"{_named(alone['counts'])} (expected {_named(want)}); tensor-core "
          f"K1/K2 in the trace of calls [10, 20) with the group "
          f"{traced['group']}, without {traced['alone']}; ms/step by epoch "
          f"(host clock over the epoch, loader included) with the group "
          f"{ranked['ms']}, without {_ms_per_step(alone['text'])}; "
          f"all-reduces a step in the window (count, ms; host ops on the "
          f"host clock, NCCL kernels on the card's): {per_step}, without "
          f"the group {reduces['alone']}; gradients all-reduced a step: G "
          f"{g:,} + {ratio} x D {d:,} fp32 values, "
          f"{4 * (g + ratio * d) / 1e6:.2f} MB (and BN's moments); launcher "
          f"{seconds:.1f} s on {card}", flush=True)
    require(same, "the one-rank group changed the training state")
    require(alone["counts"] == want and ranked["step"] == steps == 40,
            f"launches {alone['counts']}, steps {ranked['step']} / {steps}")
    require(all(t["K1mma"] == 8 * window and t["K2mma"] == 6 * window
                for t in traced.values()), f"the window's K1/K2: {traced}")
    require(host_ops >= 2 * window and not reduces["alone"],
            f"the window's all-reduces: {reduces}")


def _dp_step_jobs() -> list:
    """26b's step jobs: church64 (4 steps) and imagenet128_cond with
    ``use_pallas_sn`` (2 steps) at a per-rank batch of 64, fp32 and bf16,
    on phase 7's and phase 16's synthetic records; each fp32 config's
    first step with D frozen; and church64's fp32 jobs again with the
    planted BN fault."""
    jobs = []
    for name, path, steps, size, classes, extra in (
            ("church64", CONFIG, 4, 64, 1, {}),
            ("imagenet128_cond", IMAGENET128, 2, 128, 1000,
             {"use_pallas_sn": True})):
        pairs = list(synthetic_images(steps * 128, size, classes, SEED))
        images = np.stack([p[0] for p in pairs]).reshape(
            steps, 128, size, size, 3)
        labels = np.asarray([p[1] for p in pairs], np.int32).reshape(
            steps, 128)
        for dtype in ("float32", "bfloat16"):
            jobs.append({"kind": "steps", "name": name, "dtype": dtype,
                         "config": _dp_config(path, dtype, img_size=size,
                                              num_classes=classes, **extra),
                         "global_batch": 128, "seed": SEED + 26,
                         "images": images, "labels": labels})
        full = jobs[-2]
        jobs.append({**full, "name": f"{name} frozen D", "frozen": True,
                     "config": {**full["config"], "lr_d": 0.0},
                     "images": images[:1], "labels": labels[:1]})
        if name == "church64":
            jobs += [{**full, "fault": True},
                     {**jobs[-1], "fault": True}]
    return jobs


def _dp_expected(job: dict, steps: int) -> dict:
    fp32 = job["dtype"] == "float32"
    k1, k2 = ("K1", "K2") if fp32 else ("K1mma", "K2mma")
    if job["name"].startswith("church64"):
        return _launches(**{k1: 8 * steps, k2: 6 * steps})
    return _launches(**{k1: 12 * steps, k2: 8 * steps,
                        "K7": SN_CALLS_PER_STEP * steps,
                        "K7w": SN_PER_STEP * steps,
                        "K7bwd": SN_BWD_PER_STEP * steps})


def _rel_err(x, y) -> float:
    return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30)))


def _dp_errors(got: dict, want: dict, job: dict,
               per_variable: bool = True) -> tuple:
    """({reading: worst error}, [what is beyond its tolerance]) of a
    run's metrics and state against another's, at ``job``'s limits (the
    per-variable norms of a frozen step held only with
    ``per_variable``)."""
    fp32, frozen = job["dtype"] == "float32", job.get("frozen", False)
    rtol = (DP_FROZEN_RTOL if frozen else
            DP_FP32_RTOL if fp32 else DP_BF16_RTOL)
    worst, bad = {}, []
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in DP_STEP_KEYS:
            err = _rel_err(g[key], w[key])
            worst[f"{key} rel"] = max(worst.get(f"{key} rel", 0.0), err)
            if not np.isfinite(g[key]).all() or err > rtol:
                bad.append(f"step {i} {key} {float(g[key]):.9g} vs "
                           f"{float(w[key]):.9g}")
        for key in ("G_grad_norms", "D_grad_norms"):
            # over phase 6's per-norm limit (held in the frozen step)
            share = np.abs(g[key] - w[key]) / (STEP_RTOL * np.abs(w[key])
                                               + STEP_ATOL)
            worst[f"{key} err/limit"] = max(
                worst.get(f"{key} err/limit", 0.0), float(share.max()))
            if frozen and per_variable and share.max() > 1:
                bad.append(f"step {i} {key}: {int((share > 1).sum())} "
                           f"beyond phase 6's limit")
    limits = ({"params": 3 * job["config"]["lr_g"],
               "BN stats": DP_FROZEN_BUFFER_TOL,
               "SN u": DP_FROZEN_BUFFER_TOL} if frozen else
              {"params": 3 * want["lr"], "BN stats": DP_FP32_BN_TOL,
               "SN u": DP_FP32_U_TOL})
    kinds = want["buffers"]
    require(got["state"].keys() == want["state"].keys(),
            "the states hold other tensors")
    for name, y in want["state"].items():
        kind = kinds.get(name, "params")
        diff = (got["state"][name].double() - y.double()).abs()
        if not diff.numel():
            continue
        if kind != "params":
            diff = diff / y.double().abs().clamp(min=1.0)
        err = diff.max().item()
        worst[f"{kind} max"] = max(worst.get(f"{kind} max", 0.0), err)
        if fp32 and err > limits[kind]:
            bad.append(f"{name} ({kind}) {err:.3g}")
    return worst, bad


def _dp_summary(errs: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())


def _check_dp_steps(job: dict, ranks: list, one: dict, card: str,
                    control: dict | None = None) -> None:
    """Two ranks against one process at the global batch (and the control
    against it), and the ranks against each other; a job with the planted
    fault must fail the comparison."""
    r0, r1 = ranks
    fp32 = job["dtype"] == "float32"
    fault = job.get("fault", False)
    steps = len(one["metrics"])
    same = r0["state"].keys() == r1["state"].keys() and all(
        torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    errs, bad = _dp_errors(r0, one, job)
    want_counts = _dp_expected(job, steps)
    g, d, ratio = r0["reduced"]
    if job.get("frozen"):
        tol = (f"losses and global norms rtol {DP_FROZEN_RTOL:g}, "
               f"per-variable norms phase 6's, params "
               f"{3 * job['config']['lr_g']:g}, BN stats and SN u "
               f"{DP_FROZEN_BUFFER_TOL:g}")
    elif fp32:
        tol = (f"losses and global norms rtol {DP_FP32_RTOL:g}, params "
               f"{3 * one['lr']:g}, BN stats {DP_FP32_BN_TOL:g}, SN u "
               f"{DP_FP32_U_TOL:g}")
    else:
        tol = f"losses and global norms rtol {DP_BF16_RTOL:g}"
    title = (f"{job['name']} {job['dtype']}"
             f"{' WITH THE PLANTED BN FAULT' if fault else ''}")
    control_text = ""
    if control is not None:
        control_text = ("; the control, one process with the real images "
                        "reversed: "
                        + _dp_summary(_dp_errors(control, one, job)[0]))
    print(f"phase 26b {title} per-rank batch 64 (global 128), {steps} "
          f"steps: 2 gloo ranks on one card vs one process at batch 128: "
          f"{_dp_summary(errs)} (tol {tol}; beyond it: "
          f"{len(bad)} {bad[:3]}){control_text}; ranks bit for bit "
          f"{same}; gradients all-reduced a step: G {g:,} + {ratio} x D "
          f"{d:,} fp32 values, {4 * (g + ratio * d) / 1e6:.2f} MB; launches "
          f"per rank {_named(r0['counts'])} / {_named(r1['counts'])} "
          f"(expected {_named(want_counts)}); seconds: ranks "
          f"{r0['seconds']:.2f} / {r1['seconds']:.2f}, one process "
          f"{one['seconds']:.2f} (host clock, synchronised; two processes "
          f"share one card: a correctness configuration, not a scaling "
          f"figure) on {card}", flush=True)
    require(same, f"26b {title}: the ranks' states differ")
    require(r0["counts"] == r1["counts"] == want_counts,
            f"26b {title}: launches {r0['counts']}, {r1['counts']}, "
            f"expected {want_counts}")
    if fault:
        require(bad, f"26b {title}: the limits do not see the fault")
    else:
        require(not bad, f"26b {title}: {bad[:8]}")


def _dp_cli_jobs() -> tuple:
    """26c's CLI runs on phase 7's records written again in 3 shard files
    (rank 0 reads 2, rank 1 one): one epoch on the host feed, one on the
    device cache writing a checkpoint, and a restart for another epoch."""
    data = DP_DIR / "church64_3shards"
    if not (data / "metadata.pickle").exists():
        make_synthetic_dataset(str(data), num=SMOKE_RECORDS, img_size=64,
                               num_classes=1, seed=SEED, num_shards=3)
    ckpt = DP_DIR / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = (("host", 1, {"device_cache": False}),
            ("cache", 1, {"ckpt_dir": str(ckpt)}),
            ("restart", 2, {"ckpt_dir": str(ckpt)}))
    jobs = []
    for label, epochs, extra in runs:
        cfg = _church64_file(DP_DIR / f"church64_dp_c_{label}.py", data,
                             epochs, steps_per_call=8, num_devices=2,
                             **extra)
        jobs.append({"label": label, "epochs": epochs, "argv": [
            "--config_path", str(cfg), "--device", "cuda:0",
            "--dist_backend", "gloo"]})
    return jobs, ckpt


def phase_dp_cli(card: str) -> None:
    """26c: the CLI on two gloo ranks sharing the card, one
    ``torch.distributed.run`` of ``sagan_tpu_torch.main`` a run."""
    jobs, ckpt = _dp_cli_jobs()
    ranks, lines, seconds = {}, [], 0.0
    for job in jobs:
        texts, secs = _launch(f"dp_c_{job['label']}", 2,
                              ["-m", "sagan_tpu_torch.main", *job["argv"]])
        seconds += secs
        ranks[job["label"]] = a, b = [_cli_rank(t) for t in texts]
        lines.append(f"{job['label']}: steps {a['step']}/{b['step']}, "
                     f"device cache {a['cache']}/{b['cache']}, digests "
                     f"{'equal' if a['digest'] == b['digest'] else 'DIFFER'}"
                     f", ms/step {a['ms']}")
        require(a["digest"] == b["digest"] and a["step"] == b["step"]
                and a["total"] == b["total"],
                f"26c {job['label']}: the ranks disagree")
    host, cache, restart = (ranks[j["label"]] for j in jobs)
    spe = host[0]["total"]
    saved = sorted(os.listdir(ckpt))
    print(f"phase 26c CLI, 2 gloo ranks on one card, church64 bf16 per-rank "
          f"batch 64 over 3 uneven shards ({SMOKE_RECORDS} records; rank 0 "
          f"2 files, rank 1 one, which wraps): {spe} steps an epoch; "
          f"{'; '.join(lines)}; host feed vs device cache "
          f"{'bit for bit' if host[0]['digest'] == cache[0]['digest'] else 'DIFFER'}"
          f"; checkpoints {saved}, restored at steps "
          f"{[r['restored'] for r in restart]}; launchers {seconds:.1f} s "
          f"on {card}", flush=True)
    require(spe == (SMOKE_RECORDS // 2) // DP_BATCH and host[0]["step"] == spe
            and cache[0]["step"] == spe and restart[0]["step"] == 2 * spe
            and restart[0]["total"] == 2 * spe,
            "26c: the ranks did not take steps_per_epoch steps an epoch")
    require(not any(r["cache"] for r in host)
            and all(r["cache"] for r in cache + restart),
            "26c: the feeds are not the host's and the device cache's")
    require(host[0]["digest"] == cache[0]["digest"],
            "26c: the device cache and the host feed trained apart")
    require(saved == [f"ckpt-{spe:08d}.pt", f"ckpt-{2 * spe:08d}.pt"]
            and all(r["restored"] == spe for r in restart),
            f"26c checkpoints {saved}, restored "
            f"{[r['restored'] for r in restart]}")


def phase_dp_serve(gen32, card: str, served: dict | None) -> None:
    """26d: ``GeneratorService`` at ``num_devices`` 1 on phase 4's weights
    serves phase 4's bytes; two replicas on the one card (``devices``
    cuda:0 twice, each slice on its own inference thread) serve the
    one-device images of the same chunks (fp32, within 1 LSB: cuDNN may
    take other algorithms at half the batch); ``serve --num_devices 2``
    on one card raises, naming the counts."""
    weights = ROOT / "build" / "smoke" / "church64_g.npz"
    config = church64_config("bfloat16")
    if not weights.exists():
        export_generator_npz(gen32, str(weights), config)
    gen = load_generator_npz(config, str(weights), "cuda")
    svc = GeneratorService(gen, z_dim=config["z_dim"], num_classes=1,
                           batch=64, ladder=(1, 8), num_devices=1)
    try:
        got = {(n, rep): svc.sample(n, rep, -1, 0.0).tobytes()
               for n, rep in (served or {})}
    finally:
        svc.close()
    same = all(got[key] == body for key, body in (served or {}).items())
    fp32 = church64_config("float32")
    gen = load_generator_npz(fp32, str(weights), "cuda")
    one = GeneratorService(gen, z_dim=128, num_classes=1, batch=64,
                           ladder=(2, 8))
    two = GeneratorService(gen, z_dim=128, num_classes=1, batch=64,
                           ladder=(1, 8), num_devices=2,
                           devices=["cuda:0", "cuda:0"])
    try:
        worst = 0
        for n, seed in ((1, 0), (8, 1), (64, 2), (70, 3)):
            a = one.sample(n, seed, -1, 0.0).astype(np.int16)
            b = two.sample(n, seed, -1, 0.0).astype(np.int16)
            worst = max(worst, int(np.abs(a - b).max()))
        ladders = (one.ladder, two.ladder)
    finally:
        one.close()
        two.close()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve_main(["--config_path", str(CONFIG), "--weights",
                        str(weights), "--num_devices", "2"])
        refused = "no error"
    except ValueError as err:
        refused = str(err)
    print(f"phase 26d serve: num_devices 1 gives phase 4's bytes for "
          f"{len(got)} requests: {same if served else 'phase 4 not run'}; "
          f"two replicas on one card (ladders {ladders}) vs one device, "
          f"fp32: max |diff| {worst} LSB (tol 1); serve --num_devices 2 "
          f"raises: {refused} on {card}", flush=True)
    require(same and worst <= 1 and ladders[0] == ladders[1] == [2, 8, 64],
            "26d: serving at num_devices 1 or 2 disagrees")
    require("requested 2 devices, have 1" in refused,
            f"serve --num_devices 2 on one card: {refused}")


MP_DIR = ROOT / "build" / "smoke" / "mp"
POD = ROOT / "example_configs" / "biggan128_pod.py"
MP_BATCH = 8              # the pod config's per-device batch: the global
#                           batch of a 1 x 2 grid
MP_STEPS = 4
MP_CLASSES = 1000
MP_RECORDS = 64           # 27c's data_size: 8 steps an epoch
JAX_SN_MESSAGE = ("model_parallel > 1: SN stays on the XLA backend (the "
                  "weight operand is model-sharded; a fused single-shard "
                  "kernel would gather it)")
# biggan128_pod's four steps at batch 8 and the config's learning rates:
# one process against itself with its real images reordered (a control)
# read beyond 26b's limits on an H100 80GB HBM3 at 700 W (reversed: G_loss
# 3.65e-3 to 1.09e-2 over three calls, BN stats 8.4e-4 to 9.0e-4, SN u
# 1.6e-3 to 2.1e-3, params 1.15e-3 to 1.17e-3 against 5e-3, 1.2e-4, 6e-4
# and 3 lr_d): at batch 8 Adam's +-lr moves of noise-level gradients weigh
# more than at 26b's 64, and G_loss (~0.2) moved 3x between calls.  So
# three controls are run (the images reversed, rolled by half a batch and
# in a seeded order) and each reading of those steps is held at 26b's
# limit or at MP_CONTROL_FACTOR times the controls' worst reading,
# whichever is larger: the factor 26b took over its control's worst.
MP_CONTROL_FACTOR = 4
MP_CONTROL_ORDERS = {
    "reversed": np.arange(MP_BATCH)[::-1],
    "rolled": np.roll(np.arange(MP_BATCH), MP_BATCH // 2),
    "seeded": np.random.default_rng(SEED + 27).permutation(MP_BATCH)}


@contextlib.contextmanager
def _planted_mp_fault(kind: str | None):
    """While open: ``"world_mean"`` takes the gradient mean (and BN's
    moments) over the world instead of the data group, so a rank's
    sharded gradient is averaged with its model peer's other shard;
    ``"gather_sum"`` makes the gathered output's backward sum the
    cotangent over the model group before taking this rank's slice."""
    saved = mesh.data_group, mesh._GatherShards.backward
    if kind == "world_mean":
        mesh.data_group = lambda: None
    elif kind == "gather_sum":
        def summed(ctx, grad):
            grad = mesh.all_reduce_(grad.clone(), group=mesh.model_group())
            return (grad.narrow(ctx.dim, mesh.model_index() * ctx.size,
                                ctx.size).contiguous(), None)
        mesh._GatherShards.backward = staticmethod(summed)
    elif kind is not None:
        raise ValueError(kind)
    try:
        yield
    finally:
        mesh.data_group = saved[0]
        mesh._GatherShards.backward = staticmethod(saved[1])


def _mp_step_jobs() -> list:
    """27a/27b/27d's step jobs on biggan128_pod at the global batch of 8:
    fp32 four steps, the fp32 first step with D frozen, bf16 four steps,
    and the frozen step again under each planted fault.  The ranks' config
    asks for K7 (``use_pallas_sn``), which model parallelism drops with
    JAX's message."""
    pairs = list(synthetic_images(MP_STEPS * MP_BATCH, 128, MP_CLASSES,
                                  SEED))
    images = np.stack([p[0] for p in pairs]).reshape(
        MP_STEPS, MP_BATCH, 128, 128, 3)
    labels = np.asarray([p[1] for p in pairs], np.int32).reshape(
        MP_STEPS, MP_BATCH)
    jobs = []
    for dtype in ("float32", "bfloat16"):
        jobs.append({"kind": "steps", "name": "biggan128_pod",
                     "dtype": dtype, "model_parallel": 2,
                     "config": _dp_config(POD, dtype, img_size=128,
                                          num_classes=MP_CLASSES,
                                          use_pallas_sn=True),
                     "global_batch": MP_BATCH, "seed": SEED + 27,
                     "images": images, "labels": labels})
    full = jobs[0]
    frozen = {**full, "name": "biggan128_pod frozen D", "frozen": True,
              "config": {**full["config"], "lr_d": 0.0},
              "images": images[:1], "labels": labels[:1]}
    jobs.insert(1, frozen)
    jobs += [{**frozen, "mp_fault": fault}
             for fault in ("world_mean", "gather_sum")]
    return jobs


def _one_process(job: dict) -> dict:
    """The job's one-process reference: the config without the ranks'
    K7 request, on the card."""
    config = {k: v for k, v in job["config"].items() if k != "use_pallas_sn"}
    return dp_steps({**job, "config": config, "mp_fault": None},
                    torch.device("cuda"))


def _mp_limit(reading: str, job: dict, one: dict) -> float | None:
    """26b's limit of a reading of a run at the config's learning rates
    (None: not held, as the per-variable norms, or a bf16 run's state)."""
    fp32 = job["dtype"] == "float32"
    if reading.endswith(" rel"):
        return DP_FP32_RTOL if fp32 else DP_BF16_RTOL
    if not fp32 or reading.endswith("err/limit"):
        return None
    return {"params max": 3 * one["lr"], "BN stats max": DP_FP32_BN_TOL,
            "SN u max": DP_FP32_U_TOL}[reading]


def _worst_variables(got: dict, want: dict, n: int = 3) -> str:
    """The ``n`` per-variable gradient norms furthest over phase 6's
    per-norm limit, by name, in the first step."""
    rows = []
    for key, names in (("G_grad_norms", want["names"][0]),
                       ("D_grad_norms", want["names"][1])):
        g, w = got["metrics"][0][key], want["metrics"][0][key]
        share = np.abs(g - w) / (STEP_RTOL * np.abs(w) + STEP_ATOL)
        rows += [(float(share[i]), f"{key[0]}/{names[i]} {float(g[i]):.4g} "
                  f"vs {float(w[i]):.4g}") for i in range(len(names))]
    return "; ".join(f"{text} ({share:.2f} of the limit)"
                     for share, text in sorted(rows, reverse=True)[:n])


def _check_mp_steps(job: dict, ranks: list, one: dict, card: str,
                    controls: list | None) -> None:
    """27a/27d: the two ranks of the 1 x 2 grid against one process at
    the global batch, and against each other.  The frozen step is held at
    26b's frozen limits on the losses, global norms, BN stats and SN u;
    the runs at the config's learning rates at 26b's limits or
    MP_CONTROL_FACTOR times the worst of their ``controls``' readings.  A
    planted fault must fail the comparison."""
    r0, r1 = ranks
    fault = job.get("mp_fault")
    steps = len(one["metrics"])
    same = r0["state"].keys() == r1["state"].keys() and all(
        torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
    errs, bad = _dp_errors(r0, one, job, per_variable=False)
    control_text = ""
    if controls:
        control_errs = {}
        for control in controls:
            for reading, err in _dp_errors(control, one, job)[0].items():
                control_errs[reading] = max(control_errs.get(reading, 0.0),
                                            err)
        bad = [f"step {i} {key} not finite" for i, m in enumerate(
            r0["metrics"]) for key in DP_STEP_KEYS
            if not np.isfinite(m[key]).all()]
        for reading, err in errs.items():
            base = _mp_limit(reading, job, one)
            if base is not None:
                limit = max(base, MP_CONTROL_FACTOR
                            * control_errs.get(reading, 0.0))
                if not err <= limit:
                    bad.append(f"{reading} {err:.3g} > {limit:.3g}")
        control_text = (f"; the {len(controls)} controls, one process "
                        f"with the real images reordered "
                        f"({', '.join(MP_CONTROL_ORDERS)}), worst: "
                        + _dp_summary(control_errs))
    title = (f"{job['name']} {job['dtype']}"
             f"{f' WITH THE PLANTED FAULT {fault}' if fault else ''}")
    print(f"phase 27{'d' if fault else 'a'} {title} global batch "
          f"{MP_BATCH}, {steps} steps: 2 gloo ranks on one card (a 1 x 2 "
          f"grid, {r0['sharded']} weights sharded) vs one process: "
          f"{_dp_summary(errs)} (beyond the limits: {len(bad)} "
          f"{bad[:3]}){control_text}; the per-variable norms furthest "
          f"over phase 6's limit: {_worst_variables(r0, one)}; ranks' "
          f"whole states bit for bit {same} on {card}", flush=True)
    if fault:
        require(bad, f"27d {title}: the limits do not see the fault")
    else:
        require(same, f"27a {title}: the ranks' states differ")
        require(not bad, f"27a {title}: {bad[:8]}")


def _check_mp_holdings(job: dict, ranks: list, one: dict, card: str) -> None:
    """27b: what each rank holds and runs against one process."""
    steps = len(one["metrics"])
    per_step = {k: v / steps for k, v in one["counts"].items() if v}
    lines = []
    for r, res in enumerate(ranks):
        share = {k: res["held"][k] / one["held"][k] for k in res["held"]}
        lines.append(
            f"rank {r}: params {res['held']['params'] / 2**20:.1f} MiB, Adam "
            f"{res['held']['adam'] / 2**20:.1f} MiB, EMA "
            f"{res['held']['ema'] / 2**20:.1f} MiB (shares of one "
            f"process's: {', '.join(f'{k} {v:.3f}' for k, v in share.items())}"
            f"), peak {res['peak'] / 2**30:.2f} GiB, "
            f"{1e3 * res['seconds'] / steps:.0f} ms a step, launches "
            f"{_named(res['counts'])}")
        require(all(0.4 < v < 0.75 for v in share.values()),
                f"27b rank {r} holds {share} of one process's state")
        require(res["counts"] == one["counts"],
                f"27b rank {r} launches {res['counts']}, one process "
                f"{one['counts']}")
    print(f"phase 27b {job['dtype']} per rank: {'; '.join(lines)}; one "
          f"process: params {one['held']['params'] / 2**20:.1f} MiB, Adam "
          f"{one['held']['adam'] / 2**20:.1f} MiB, EMA "
          f"{one['held']['ema'] / 2**20:.1f} MiB, peak "
          f"{one['peak'] / 2**30:.2f} GiB, "
          f"{1e3 * one['seconds'] / steps:.0f} ms a step; launches a step "
          f"{_named(per_step)} (the ranks' equal one process's at the same "
          f"batch; no K7); ms a step on the host clock, synchronised: two "
          f"ranks share one card and gloo moves every gather through the "
          f"host, so this is no scaling figure; rank 0 printed: "
          f"{ranks[0]['announced'].strip()!r} on {card}", flush=True)
    require(JAX_SN_MESSAGE in ranks[0]["announced"]
            and not ranks[1]["announced"],
            "27b: JAX's SN message was not printed once")
    require(not any(v for k, v in ranks[0]["counts"].items()
                    if k.startswith("K7"))
            and ranks[0]["counts"].get(
                "K1" if job["dtype"] == "float32" else "K1mma", 0) > 0,
            f"27b: launches {ranks[0]['counts']}")


def _imagenet_folder(root: Path) -> Path:
    """An ImageNet-layout tree ``train/n<8 digits>/`` of MP_CLASSES class
    directories, one seeded PNG each (landscape and portrait, some
    grayscale), written once."""
    from PIL import Image

    done = root / "done"
    if not done.exists():
        shutil.rmtree(root, ignore_errors=True)
        rng = np.random.default_rng(SEED)
        for c in range(MP_CLASSES):
            d = root / "train" / f"n{c:08d}"
            d.mkdir(parents=True)
            w, h = (160, 136) if c % 2 else (136, 160)
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                               dtype=np.uint8))
            if c % 7 == 0:
                img = img.convert("L")
            img.save(d / f"n{c:08d}_0.JPEG", format="PNG")
        done.write_text("ok")
    return root


def _checkpoint_digest(path: Path) -> str:
    """``main.state_digest`` of the whole state in a checkpoint file."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = types.SimpleNamespace(gen=types.SimpleNamespace(
        state_dict=lambda: ckpt["gen"]), disc=types.SimpleNamespace(
        state_dict=lambda: ckpt["disc"]), ema=ckpt["ema"])
    return train_cli.state_digest(types.SimpleNamespace(
        state=state, g_axes={}, d_axes={}))


def phase_mp_cli(card: str) -> None:
    """27c: convert, train on the two ranks through the CLI, restart,
    sample in one process."""
    from sagan_tpu_torch.data.tfrecord import load_metadata

    src = _imagenet_folder(MP_DIR / "imagenet_folder")
    data = MP_DIR / "imagenet_labeled_128"
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "sagan_tpu_torch.data.convert", "--path",
         str(src), "--dataset", "imagenet", "--img_size", "128",
         "--out_dir", str(data)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=DP_TIMEOUT)
    convert_s = time.perf_counter() - t0
    require(out.returncode == 0, f"27c convert: {out.stderr[-2000:]}")
    meta = load_metadata(str(data))
    ds = ImageDataset(str(data), batch_size=MP_BATCH, num_workers=1)
    imgs, labels = next(iter(ds.epoch(0)))
    require(meta == {"img_size": 128, "num_classes": MP_CLASSES,
                     "num_records": MP_CLASSES}
            and imgs.shape == (MP_BATCH, 128, 128, 3)
            and labels.max() < MP_CLASSES,
            f"27c converted metadata {meta}, batch {imgs.shape}")
    ckpt = MP_DIR / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    extra = {"data_path": str(data), "data_size": MP_RECORDS,
             "model_parallel": 2, "use_pallas_sn": True,
             "ckpt_dir": str(ckpt), "log_dir": str(MP_DIR / "logs"),
             "img_dir": str(MP_DIR / "images"), "summary_step_freq": 4,
             "fid_epoch_freq": 0, "print_variables": False,
             "num_devices": None}
    texts, seconds = {}, 0.0

    def config_file(label: str, **more) -> Path:
        path = MP_DIR / f"biggan128_pod_mp_{label}.py"
        path.write_text(f"import runpy\n"
                        f"config = dict(runpy.run_path({str(POD)!r})"
                        f"['config'])\n"
                        f"config.update({{**{extra!r}, **{more!r}}})\n")
        return path

    for label, epochs in (("run", 1), ("restart", 2)):
        cfg = config_file(label, epoch=epochs)
        got, secs = _launch(f"mp_c_{label}", 2, [
            "-m", "sagan_tpu_torch.main", "--config_path", str(cfg),
            "--device", "cuda:0", "--dist_backend", "gloo"])
        seconds += secs
        texts[label] = got
    run, restart = ([_cli_rank(t) for t in texts[k]]
                    for k in ("run", "restart"))
    spe = MP_RECORDS // MP_BATCH
    saved = sorted(os.listdir(ckpt))
    digests = {step: _checkpoint_digest(ckpt / f"ckpt-{step:08d}.pt")
               for step in (spe, 2 * spe)}
    grids = sorted(os.listdir(MP_DIR / "images"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        written = generate.main([
            "--config_path", str(config_file("one", model_parallel=1)),
            "--device", "cuda", "--num", "16", "--batch", "8", "--format",
            "npz", "--out", str(MP_DIR / "samples")])
    samples = np.load(written[0])["images"]
    print(f"phase 27c CLI: {MP_CLASSES} class directories converted by "
          f"sagan_tpu_torch.data.convert in {convert_s:.1f} s ({meta}); "
          f"biggan128_pod bf16 on 2 gloo ranks (1 x 2 grid) on one card, "
          f"{MP_RECORDS} records: steps {[r['step'] for r in run]} then "
          f"{[r['step'] for r in restart]} (restored at "
          f"{[r['restored'] for r in restart]}), ms/step {run[0]['ms']} / "
          f"{restart[0]['ms']}; the ranks' whole-state digests equal the "
          f"checkpoints': {run[0]['digest'] == digests[spe]} / "
          f"{restart[0]['digest'] == digests[2 * spe]}; checkpoints "
          f"{saved}, sample grids {grids}; JAX's SN message on rank 0: "
          f"{JAX_SN_MESSAGE in texts['run'][0]}; generate at "
          f"model_parallel 1: {out.getvalue().strip()} {samples.shape} "
          f"std {samples.std():.2f}; launchers {seconds:.1f} s on {card}",
          flush=True)
    require(all(r["step"] == spe and r["total"] == spe for r in run)
            and all(r["step"] == 2 * spe and r["restored"] == spe
                    for r in restart),
            "27c: the ranks did not train and resume as asked")
    require(run[0]["digest"] == run[1]["digest"] == digests[spe]
            and restart[0]["digest"] == restart[1]["digest"]
            == digests[2 * spe],
            "27c: the ranks' gathered state is not the checkpoint")
    require(saved == [f"ckpt-{spe:08d}.pt", f"ckpt-{2 * spe:08d}.pt"]
            and grids and JAX_SN_MESSAGE in texts["run"][0]
            and JAX_SN_MESSAGE not in texts["run"][1],
            f"27c: checkpoints {saved}, grids {grids}")
    require("(EMA generator)" in out.getvalue()
            and samples.shape == (16, 128, 128, 3) and samples.std() > 0,
            "27c: generate did not sample the EMA G")


def phase_mp(card: str) -> None:
    """Phase 27: model parallelism on the one card (see the module
    docstring).  Every check runs and prints; the phase then fails on the
    first that failed."""
    MP_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    failed = []

    def check(fn, *args):
        try:
            fn(*args)
        except AssertionError as err:
            print(f"phase 27 FAILED: {err}", flush=True)
            failed.append(err)

    jobs = _mp_step_jobs()
    ranks, seconds = _launch_ranks(jobs, "mp_ab", 2, "gloo")
    print(f"phase 27a: the two-rank launcher took {seconds:.1f} s",
          flush=True)
    refs = {}
    for i, job in enumerate(jobs):
        key = (job["name"], job["dtype"])
        controls = None
        if key not in refs:
            refs[key] = _one_process(job)
            if not job.get("frozen"):
                controls = [_one_process({
                    **job, "images": np.ascontiguousarray(
                        job["images"][:, order]),
                    "labels": np.ascontiguousarray(job["labels"][:, order])})
                    for order in MP_CONTROL_ORDERS.values()]
        got = [r[i] for r in ranks]
        check(_check_mp_steps, job, got, refs[key], card, controls)
        if not job.get("frozen"):
            check(_check_mp_holdings, job, got, refs[key], card)
    check(phase_mp_cli, card)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s", flush=True)
    require(not failed, f"phase 27: {len(failed)} check(s) failed, the "
                        f"first: {failed[0] if failed else ''}")


def phase_dp(card: str, gen32, served: dict | None) -> None:
    """Phase 26: data parallelism on the one card (see the module
    docstring).  Every check runs and prints; the phase then fails on the
    first that failed."""
    DP_DIR.mkdir(parents=True, exist_ok=True)
    failed = []

    def check(fn, *args):
        try:
            fn(*args)
        except AssertionError as err:
            print(f"phase 26 FAILED: {err}", flush=True)
            failed.append(err)

    check(phase_dp_one_rank, card)
    jobs = _dp_step_jobs()
    ranks, seconds = _launch_ranks(jobs, "dp_b", 2, "gloo")
    print(f"phase 26b: the two-rank launcher took {seconds:.1f} s (start-up "
          f"of two processes on one card included)", flush=True)
    refs = {}   # one process's run of each job (a planted fault's twin's)
    for i, job in enumerate(jobs):
        key = (job["name"], job["dtype"])
        control = None
        if key not in refs:
            refs[key] = dp_steps(job, torch.device("cuda"))
            if job["dtype"] == "float32":
                control = dp_steps({**job, "images": np.ascontiguousarray(
                    job["images"][:, ::-1]), "labels": np.ascontiguousarray(
                    job["labels"][:, ::-1])}, torch.device("cuda"))
        check(_check_dp_steps, job, [r[i] for r in ranks], refs[key], card,
              control)
    check(phase_dp_cli, card)
    check(phase_dp_serve, gen32, card, served)
    require(not failed, f"phase 26: {len(failed)} check(s) failed, the "
                        f"first: {failed[0] if failed else ''}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--only", type=int, nargs="+", metavar="PHASE",
                    help="run only these phases (1 always runs; 4 needs 3) "
                         "and print no kernels line and no result line")
    ap.add_argument("--rank-jobs", metavar="PICKLE",
                    help="run as one rank of phase 26b's or 27's group "
                         "(started by torch.distributed.run) on the jobs "
                         "in this file")
    args = ap.parse_args(argv)
    if args.rank_jobs:
        return rank_worker(args.rank_jobs)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    on = set(range(1, 28)) if args.only is None else set(args.only) | {1}
    r = {}
    phase_build()
    if 2 in on:
        r["head"] = phase_kernels(card)
        phase_all_widths()
    gen32, served = None, None
    if {3, 4, 26} & on:
        gen32 = phase_generator(card)
        if 4 in on:
            served = phase_serve(gen32, card)
    if 5 in on:
        r["bwd_head"] = phase_bwd_kernels(card)
        phase_bwd_all_widths()
    if 6 in on:
        r["fp32_step"] = phase_train_step(card)
    if 7 in on:
        r["fwd_launches"], r["bwd_launches"] = phase_train_cli(card)
    if 8 in on:
        r["flash"] = phase_flash_kernels(card)
    if 9 in on:
        phase_flash_all_widths()
    if 10 in on:
        r["autograd"] = phase_flash_autograd()
    if 11 in on:
        r["serve512"] = phase_serve512(card)
    if 12 in on:
        r["train512"] = phase_train512(card)
    if 13 in on:
        r["step_b8"] = phase_step512_b8(card)
    if 14 in on:
        r["sn"] = phase_sn_kernels(card)
    if 15 in on:
        phase_generator128(card)
    if 16 in on:
        r["train128"] = phase_train128(card)
    if 17 in on:
        phase_serve128(card)
    if 18 in on:
        phase_step_gf64(card)
    if 19 in on:
        phase_legacy(card)
    if 20 in on:
        r["study_heads"] = phase_study_kernels(card)
    if 21 in on:
        r["study_launches"] = phase_studies(card)
    if 22 in on:
        phase_feeds(card)
    if 23 in on:
        phase_remat512(card)
    if 24 in on:
        phase_accum128(card)
    if 25 in on:
        phase_evaluate(card)
    if 26 in on:
        phase_dp(card, gen32, served)
    del gen32
    if 27 in on:
        phase_mp(card)
    print(f"chip_smoke: phases {', '.join(map(str, sorted(on)))} passed in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    if args.only is not None:
        return 0
    # launches: each kernel's count on the path that runs it, zeroed just
    # before and read just after: the tensor-core K1 and K2 on the church64
    # training entry point's run (phase 7; phase 4 checks the serving
    # path's own count), the CUDA-core K1 and K2 on the fp32 church64 step
    # (phase 6), the tensor-core K3 and K6 on the church512 one (phase 12;
    # phase 11 checks church512 serving's), the CUDA-core K3 on the fp32
    # church512 G forward (phase 11) and the CUDA-core K6 on the fp32
    # FlashAttention run (phase 10), K4 and K5 on phase 13's church512
    # steps past the slab budget (the tensor-core ones at B=16 in bf16, the
    # CUDA-core ones at B=8 in fp32; their times at B=8), K7 and its
    # backward on the imagenet128_cond training
    # entry point's run (phase 16; phase 17 checks its serving path's own
    # count), the study
    # kernels on the four studies' runs (phase 21)
    src = "sagan_tpu_torch/csrc/"
    ref = "sagan_tpu/ops/pallas_attention.py:"
    flash, train512 = r["flash"][4], r["train512"]
    b8, step_b8 = r["flash"][8], r["step_b8"]
    kernels = [{"name": "attention_fwd_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "157", "launches": r["fwd_launches"],
                **r["head"]["mma"]},
               {"name": "attention_fwd", "route": "cuda",
                "source": src + "attention_fwd.cu", "replaces": ref + "157",
                "launches": r["fp32_step"]["K1"], **r["head"]["fma"]},
               {"name": "attention_bwd_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "207", "launches": r["bwd_launches"],
                **r["bwd_head"]["mma"]},
               {"name": "attention_bwd", "route": "cuda",
                "source": src + "attention_bwd.cu", "replaces": ref + "207",
                "launches": r["fp32_step"]["K2"], **r["bwd_head"]["fma"]},
               {"name": "attention_flash_fwd_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "368", "launches": train512["K3mma"],
                **flash["fwd"]},
               {"name": "attention_flash_fwd", "route": "cuda",
                "source": src + "attention_fwd.cu", "replaces": ref + "368",
                "launches": r["serve512"]["fp32"], **flash["fwd_fma"]},
               {"name": "attention_flash_dq_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "444",
                "launches": step_b8["bfloat16_b16"]["K4mma"], **b8["dq"]},
               {"name": "attention_flash_dq", "route": "cuda",
                "source": src + "attention_flash_bwd.cu",
                "replaces": ref + "444",
                "launches": step_b8["float32"]["K4"], **b8["dq_fma"]},
               {"name": "attention_flash_dkv_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "515",
                "launches": step_b8["bfloat16_b16"]["K5mma"],
                **b8["dkv"]},
               {"name": "attention_flash_dkv", "route": "cuda",
                "source": src + "attention_flash_bwd.cu",
                "replaces": ref + "515",
                "launches": step_b8["float32"]["K5"], **b8["dkv_fma"]},
               {"name": "attention_flash_dqkv_mma", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "replaces": ref + "665", "launches": train512["K6mma"],
                **flash["dqkv"],
                "study_points": r["study_heads"]["k6_points"]},
               {"name": "attention_flash_dqkv", "route": "cuda",
                "source": src + "attention_flash_bwd.cu",
                "replaces": ref + "665", "launches": r["autograd"]["K6"],
                **flash["dqkv_fma"]},
               {"name": "spectral_norm", "route": "cuda",
                "source": src + "spectral_norm.cu",
                "replaces": "sagan_tpu/ops/pallas_spectral.py:31",
                "launches": r["train128"]["K7"], **r["sn"]["fwd"]},
               {"name": "spectral_norm_bwd", "route": "cuda",
                "source": src + "spectral_norm.cu",
                "replaces": "sagan_tpu/ops/pallas_spectral.py:96",
                "launches": r["train128"]["K7bwd"], **r["sn"]["bwd"]},
               {"name": "attention_study", "route": "cuda",
                "source": src + "attention_flash_mma.cu",
                "sources": [src + "attention_flash_mma.cu",
                            src + "mma_bf16.cuh", src + "attention_study.cu"],
                "replaces": "tools/bench_attn_floor.py:82",
                "launches": r["study_launches"]["attention_study"],
                **r["study_heads"]["study"]},
               {"name": "attention_folded", "route": "cuda",
                "source": src + "attention_folded.cu",
                "sources": [src + "attention_folded.cu",
                            src + "mma_bf16.cuh"],
                "replaces": "tools/bench_attn_floor.py:173",
                "launches": r["study_launches"]["attention_folded"],
                **r["study_heads"]["folded"]}]
    require(all(row["launches"] > 0 for row in kernels),
            f"a kernel was never launched on its path: "
            f"{[(row['name'], row['launches']) for row in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

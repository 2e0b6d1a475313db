"""The port stands alone: importing every module of ``sagan_tpu_torch``
and ``chip_smoke`` loads neither JAX nor the JAX package (nor the JAX
studies of ``tools/`` or ``bench.py``), and needs no nvcc or card (kernels
build at first use, not at import)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import sagan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sagan_tpu_torch.__path__,
                                                "sagan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sagan_tpu", "tools",
                                       "bench"))
print(" ".join(names), "|", leaked)
"""

# every module of the port, the training slice's, the flash slice's, the
# resnet slice's and the study slice's included (the flash path's plain
# versions and routing live in ops.attention, its wrappers and autograd
# Function in ops.cuda_attention; K7's wrapper, plain version and autograd
# Function in ops.cuda_spectral; the study kernels' plain versions in
# ops.attention_study, their wrappers in ops.cuda_attention_study, the
# studies in tools.bench_attn_* and tools._study; the other feeds in
# data.image_folder and the native reader's binding in data.native;
# evaluation in evaluate, train.fid, train.inception and train.iscore, the
# profiler window in utils.profiling, data parallelism in parallel.mesh;
# the two-tree kernel check in tools.kernel_ab, the SASS count of a
# kernel's loop in tools.sass_mix)
MODULES = {
    "convert", "evaluate", "generate", "legacy_main", "main", "serve",
    "data", "data.image_folder", "data.loader", "data.native",
    "data.synthetic", "data.tfrecord",
    "models", "models.resnet", "models.vanilla",
    "nn", "nn.attention", "nn.initializers", "nn.layers",
    "ops", "ops._build", "ops.attention", "ops.attention_study",
    "ops.cuda_attention", "ops.cuda_attention_study",
    "ops.cuda_spectral", "ops.losses", "ops.spectral",
    "parallel", "parallel.mesh",
    "tools", "tools._study", "tools.bench_attn_bwd256",
    "tools.bench_attn_floor", "tools.bench_attn_floor256",
    "tools.bench_attn_floor512", "tools.kernel_ab", "tools.profiling",
    "tools.sass_mix", "tools.serve_breakdown", "tools.train_breakdown",
    "train", "train.checkpoint", "train.fid", "train.inception",
    "train.iscore", "train.optim", "train.trainer",
    "utils", "utils.config", "utils.device", "utils.images",
    "utils.profiling", "utils.tb_writer", "utils.timing",
}


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.strip().split(" | ")
    assert {n.removeprefix("sagan_tpu_torch.")
            for n in names.split()} >= MODULES
    assert leaked == "[]"


def test_chip_smoke_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

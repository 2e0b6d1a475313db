"""The port's training CLI and loop on the CPU (``python -m
sagan_tpu_torch.main --device cpu``), on a copy of example_configs/test.py
pointed at a small synthetic dataset: it writes a TensorBoard event file,
PNG grids and a checkpoint; a re-run restores; two gloo ranks under
``torch.distributed.run`` train it data-parallel, each rank's lines
written whole to the shared stdout; a SIGTERM mid-epoch and a
resume give bit-for-bit the state of an unbroken run; ``generate``
without ``--weights`` samples the checkpoint's EMA generator; an FID epoch
prints and writes the proxy FID and IS; ``profile_dir`` traces calls
10-20; ``summary_histograms`` writes JAX's histogram encoding."""

import json
import os
import re
import signal
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from sagan_tpu.utils.tb_writer import \
    _encode_histogram_value as jax_encode_histogram
from sagan_tpu_torch import generate
from sagan_tpu_torch import main as train_cli
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.data.tfrecord import _iter_fields, read_records
from sagan_tpu_torch.train.checkpoint import CheckpointManager
from sagan_tpu_torch.train.trainer import Trainer
from sagan_tpu_torch.utils.config import load_config_file, resolve_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data32(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_ds")
    return make_synthetic_dataset(str(d), num=64, img_size=32,
                                  num_classes=1, seed=1)


def _config_file(tmp_path, data_path, **overrides):
    """A copy of example_configs/test.py with its paths under tmp_path."""
    overrides = {"data_path": data_path, "epoch": 2, "batch_size": 8,
                 "steps_per_call": 2, "summary_step_freq": 4,
                 "num_sample": 4, "num_devices": 1, "g_ema_decay": 0.9,
                 "g_ema_start": 2, "print_variables": False,
                 "log_dir": str(tmp_path / "logs"),
                 "ckpt_dir": str(tmp_path / "ckpt"),
                 "img_dir": str(tmp_path / "images"), **overrides}
    path = tmp_path / "test_copy.py"
    with open(os.path.join(ROOT, "example_configs", "test.py")) as f:
        text = f.read()
    path.write_text(f"{text}\nconfig.update({overrides!r})\n")
    return str(path)


def test_cli_trains_writes_and_restores(tmp_path, data32, capsys):
    cfg = _config_file(tmp_path, data32)
    trainer = train_cli.main(["--config_path", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Initializing from scratch." in out
    assert "epoch 1: G_loss=" in out and "ms/step)" in out
    assert trainer.global_step() == 16   # 2 epochs x 64 / 8
    logs = os.listdir(tmp_path / "logs")
    assert any(f.startswith("events.out.tfevents") and
               os.path.getsize(tmp_path / "logs" / f) > 1000 for f in logs)
    assert sorted(os.listdir(tmp_path / "images")) == [
        "epoch_0000.png", "epoch_0001.png"]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [16]
    # the compute dtype of test.py (bf16) trains with finite state
    assert trainer.state.gen.dtype == torch.bfloat16
    assert all(torch.isfinite(p).all() for p in
               trainer.state.gen.parameters())

    again = train_cli.main(["--config_path", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Restored from checkpoint at step 16" in out
    assert "training already complete" in out
    for a, b in zip(trainer.state.gen.state_dict().values(),
                    again.state.gen.state_dict().values()):
        assert torch.equal(a, b)

    # generate without --weights samples the checkpoint's EMA generator
    written = generate.main(["--config_path", cfg, "--device", "cpu",
                             "--num", "4", "--batch", "2", "--format", "npz",
                             "--out", str(tmp_path / "samples")])
    assert "(EMA generator)" in capsys.readouterr().out
    imgs = np.load(written[0])["images"]
    assert imgs.shape == (4, 32, 32, 3) and imgs.dtype == np.uint8
    gen = generate.restore_generator(
        resolve_config(load_config_file(cfg)), "cpu")
    assert not gen.training
    for name, p in gen.named_parameters():
        assert torch.equal(p, trainer.state.ema[name]), name


def _trainer(tmp_path, data_path, ckpt):
    config = resolve_config(load_config_file(_config_file(
        tmp_path, data_path, compute_dtype="float32", log_dir=None,
        img_dir=None, ckpt_dir=ckpt)))
    return Trainer(config, device="cpu")


def test_sigterm_mid_epoch_then_resume_is_bit_identical(tmp_path, data32):
    unbroken = _trainer(tmp_path, data32, None)
    unbroken.train()

    ckpt = str(tmp_path / "preempt_ckpt")
    first = _trainer(tmp_path, data32, ckpt)
    step_fn = first.train_step
    calls = {"n": 0}

    def signalled(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 6:   # the 2nd of epoch 1's 4 calls
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(*args, **kwargs)

    before = signal.getsignal(signal.SIGTERM)
    first.train_step = signalled
    first.train()
    assert signal.getsignal(signal.SIGTERM) is before
    assert first.global_step() == 12
    assert CheckpointManager(ckpt).all_steps() == [12]

    resumed = _trainer(tmp_path, data32, ckpt)
    assert resumed.global_step() == 12
    resumed.train()
    assert resumed.global_step() == unbroken.global_step() == 16
    for part in ("gen", "disc", "opt_g", "opt_d", "ema"):
        want = unbroken.checkpoint_payload()[part]
        got = resumed.checkpoint_payload()[part]
        flat_w = torch.utils._pytree.tree_leaves(want)
        flat_g = torch.utils._pytree.tree_leaves(got)
        assert len(flat_w) == len(flat_g), part
        for w, g in zip(flat_w, flat_g):
            if isinstance(w, torch.Tensor):
                assert torch.equal(w, g), part
            else:
                assert w == g, part


def test_generate_without_weights_or_checkpoint_raises(tmp_path, data32):
    cfg = _config_file(tmp_path, data32, ckpt_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="train first"):
        generate.main(["--config_path", cfg, "--device", "cpu"])


def test_generate_step_samples_the_pinned_checkpoint(tmp_path, data32,
                                                     capsys):
    """``generate --step`` samples that checkpoint's EMA generator (the
    newest is another one here), and a missing step raises ``KeyError``
    naming the saved steps."""
    trainer = _trainer(tmp_path, data32, str(tmp_path / "ckpt"))
    trainer.train(num_epochs=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == [8]
    later = trainer.checkpoint_payload()
    later["ema"] = {k: v + 1.0 for k, v in later["ema"].items()}
    mgr.save(100, {**later, "step": 100})
    cfg = _config_file(tmp_path, data32, ckpt_dir=str(tmp_path / "ckpt"),
                       compute_dtype="float32")

    def sample(*step):
        out = str(tmp_path / f"samples{step}")
        written = generate.main(["--config_path", cfg, "--device", "cpu",
                                 "--num", "4", "--batch", "4", "--format",
                                 "npz", "--out", out, *step])
        return np.load(written[0])["images"]

    pinned, newest = sample("--step", "8"), sample()
    assert "restored step 8 " in capsys.readouterr().out
    gen = trainer.eval_generator()
    want = generate.sample_images(gen, num=4, batch=4, z_dim=gen.z_dim,
                                  num_classes=1)
    np.testing.assert_array_equal(pinned, want)
    assert not np.array_equal(newest, pinned)
    with pytest.raises(KeyError, match=r"step 7; available: \[8, 100\]"):
        sample("--step", "7")
    with pytest.raises(KeyError, match="available"):
        mgr.restore_step(9)
    assert mgr.restore_step(100)["step"] == 100


def test_checkpoints_keep_the_newest_and_skip_unreadable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(5):
        mgr.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3, 4]
    with open(mgr.path(4), "wb") as f:
        f.write(b"not a checkpoint")
    assert mgr.restore_latest()["step"] == 3
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_two_ranks_train_through_the_cli(tmp_path, data32):
    """``num_devices`` 2: two gloo ranks started by ``torch.distributed.run``
    train test.py on the CPU, end at the same step with the same state
    digest, and only rank 0 writes the event file, the grids and the
    checkpoint."""
    cfg = _config_file(tmp_path, data32, num_devices=2)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "sagan_tpu_torch.main",
         "--config_path", cfg, "--device", "cpu", "--dist_backend", "gloo"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    ends = re.findall(r"^rank (\d) of 2: step (\d+) state (\w+)$",
                      out.stdout, re.MULTILINE)
    assert sorted(r for r, _, _ in ends) == ["0", "1"]
    # 64 records over 2 ranks at 8 a rank: 4 steps an epoch, 2 epochs
    assert {(step, digest) for _, step, digest in ends} == {
        ("8", ends[0][2])}
    assert out.stdout.count("epoch 1: G_loss=") == 1
    assert len([f for f in os.listdir(tmp_path / "logs")
                if f.startswith("events.out.tfevents")]) == 1
    assert sorted(os.listdir(tmp_path / "images")) == [
        "epoch_0000.png", "epoch_0001.png"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt-00000008.pt"]


# a rank of the test below: its lines to the shared stdout, each printed
# as several pieces (argv: its index)
_WRITER = """
import sys
from sagan_tpu_torch.parallel import mesh
mesh.whole_lines()
for k in range(2000):
    print("rank", sys.argv[1], "line", k, "state", 40 * "f")
"""


def test_ranks_write_whole_lines_to_a_shared_stdout():
    """Two processes printing to one pipe with ``PYTHONUNBUFFERED`` (a
    print is then several writes), each after ``mesh.whole_lines()`` as
    ``main`` calls it under the launcher: every line arrives whole, so no
    rank's closing line is split by the other's (the two-rank CLI test
    above read such a split line as a missing rank)."""
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1")
    read, write = os.pipe()
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, str(rank)],
                              cwd=ROOT, env=env, stdout=write)
             for rank in range(2)]
    os.close(write)
    with os.fdopen(read) as pipe:
        text = pipe.read()
    assert [p.wait(timeout=180) for p in procs] == [0, 0]
    lines = re.findall(r"^rank (\d) line (\d+) state f{40}$", text,
                       re.MULTILINE)
    assert len(lines) == len(text.splitlines()) == 4000
    assert sorted({(r, int(k)) for r, k in lines}) == [
        (str(r), k) for r in range(2) for k in range(2000)]


def _summaries(logdir) -> list:
    """(step, tag, Summary.Value bytes) of every summary value in the
    event files under ``logdir``."""
    out = []
    for name in sorted(os.listdir(logdir)):
        for rec in read_records(os.path.join(logdir, name)):
            fields = {f: v for f, _, v in _iter_fields(memoryview(rec))}
            if 5 not in fields:
                continue
            for f, _, value in _iter_fields(fields[5]):
                tag = next(bytes(v) for g, _, v in _iter_fields(value)
                           if g == 1)
                out.append((fields.get(2), tag.decode(), bytes(value)))
    return out


def test_an_fid_epoch_prints_and_writes_the_proxy_fid_and_is(
        tmp_path, data32, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the real statistics' cache: .cache/
    config = resolve_config(load_config_file(_config_file(
        tmp_path, data32, epoch=1, data_size=16, fid_epoch_freq=1,
        fid_num_images=16, inception_score=True, img_dir=None,
        ckpt_dir=None)))
    trainer = Trainer(config, device="cpu")
    trainer.train()
    out = capsys.readouterr().out
    fid = re.search(r"^epoch 0: proxy_FID = ([\d.]+)$", out, re.MULTILINE)
    assert fid and float(fid.group(1)) > 0
    assert re.search(r"^epoch 0: proxy_IS = [\d.]+ ± [\d.]+$", out,
                     re.MULTILINE)
    written = {tag: (step, value) for step, tag, value
               in _summaries(tmp_path / "logs")}
    step, value = written["proxy_FID"]
    got = struct.unpack("<f", value[-4:])[0]   # simple_value, last field
    assert step == 2 and got == pytest.approx(float(fid.group(1)), abs=5e-3)
    assert written["proxy_IS"][0] == 2
    assert os.listdir(tmp_path / ".cache") == [
        "synthetic_32_16_d16s0_torch_random256s42.pkl"]


def test_profile_dir_traces_calls_10_to_20(tmp_path, data32):
    """42 records at batch 2: 21 calls of one step.  The trace holds the
    optimizer steps of calls [10, 20): 2 a call (D's and G's Adam)."""
    config = resolve_config(load_config_file(_config_file(
        tmp_path, data32, epoch=1, data_size=42, batch_size=2,
        steps_per_call=1,
        summary_step_freq=100, img_dir=None, ckpt_dir=None,
        profile_dir=str(tmp_path / "prof"))))
    trainer = Trainer(config, device="cpu")
    trainer.train()
    assert trainer.global_step() == 21
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.endswith(".pt.trace.json")
    with open(tmp_path / "prof" / trace) as f:
        events = json.load(f)["traceEvents"]
    adam = [e for e in events if e.get("name") == "Optimizer.step#Adam.step"]
    assert len(adam) == 2 * 10


def test_summary_histograms_are_the_jax_encoding(tmp_path, data32):
    config = resolve_config(load_config_file(_config_file(
        tmp_path, data32, epoch=1, data_size=16, summary_histograms=True,
        img_dir=None, ckpt_dir=None)))
    trainer = Trainer(config, device="cpu")
    trainer.train()
    hists = {tag: value for step, tag, value in _summaries(tmp_path / "logs")
             if tag.startswith("hist/")}
    want = {}
    for tag, net in (("G", trainer.state.gen), ("D", trainer.state.disc)):
        for n, p in net.named_parameters():
            name = f"hist/{tag}/{n.replace('.', '/')}"
            want[name] = jax_encode_histogram(
                name, p.detach().numpy().ravel())
    assert len(want) > 10 and hists == want


def test_trainer_refuses_the_cpu_unasked(tmp_path, data32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = resolve_config(load_config_file(_config_file(tmp_path, data32)))
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(config)

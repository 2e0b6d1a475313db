"""The program's spans (``sagan_tpu_torch/utils/profiling.py`` ``span``) on
the CPU, at a tiny size: a shared no-op with no profiler running; under
the profiler, a call's ``sagan.train_step`` holding its steps, each step
its seven phases in order with the nets' and layers' spans inside, and
the step's number as its input; ``TrainStep.mark`` called as before;
one ``sagan.feed`` a call of the trainer's feed, outside the train
step; and a step computing the same bits with the profiler on as off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.train.optim import make_gan_optimizers
from sagan_tpu_torch.train.trainer import (TrainState, Trainer,
                                           build_train_step)
from sagan_tpu_torch.utils import profiling
from sagan_tpu_torch.utils.config import resolve_config
from sagan_tpu_torch.utils.profiling import span

CONFIG = {
    "dataset": "synthetic", "data_path": "unused", "model": "vanilla",
    "z_dim": 16, "gf_dim": 8, "df_dim": 8, "img_size": 16,
    "num_classes": 1, "use_attention": True, "attn_dim_G": [16],
    "attn_dim_D": [8], "use_label": False, "batch_size": 2,
    "num_devices": 1, "loss": "hinge_loss", "lr_g": 2e-4, "lr_d": 7e-4,
    "decay_rate": 0.99, "compute_dtype": "float32", "g_ema_decay": 0.9,
    "g_ema_start": 1, "seed": 0, "print_variables": False,
}
CASES = {"update_ratio_1": {},
         "update_ratio_2": {"update_ratio": 2},
         "grad_accum_2": {"grad_accum_steps": 2}}
# TrainStep.mark's stream for one step of each case, as the step called
# it before it had spans
MARKS = {
    "update_ratio_1": ["start", "fakes", "d_fwd_bwd", "d_adam", "g_fwd_bwd",
                       "g_adam", "ema", "metrics"],
    "update_ratio_2": ["start", "fakes", "d_fwd_bwd", "d_adam", "fakes",
                       "d_fwd_bwd", "d_adam", "g_fwd_bwd", "g_adam", "ema",
                       "metrics"],
    "grad_accum_2": ["start", "fakes", "d_fwd_bwd", "fakes", "d_fwd_bwd",
                     "d_adam", "g_fwd_bwd", "g_adam", "ema", "metrics"],
}
K = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny nets gain nothing from intra-op threads, which only
    contend with the other test workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(case: str):
    """(TrainStep, TrainState, images [K, B, S, S, 3], labels [K, B]) of
    ``case`` from a seeded init."""
    config = resolve_config(dict(CONFIG, **CASES[case]))
    gen = get_generator(config, rng=torch.Generator().manual_seed(0))
    disc = get_discriminator(config, rng=torch.Generator().manual_seed(1))
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        config, gen.parameters(), disc.parameters(), steps_per_epoch=10)
    ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
    state = TrainState(gen, disc, opt_g, opt_d, 0, ema)
    step = build_train_step(config, sched_g, sched_d, gen, disc)
    b, s = config["global_batch_size"], config["img_size"]
    rng = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (K, b, s, s, 3), dtype=torch.uint8,
                           generator=rng)
    return step, state, images, torch.zeros(K, b, dtype=torch.int32)


def _spans(prof) -> list:
    """[(name, start_ns, end_ns, thread, inputs)] of the profile's
    ``sagan.*`` ranges, by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                    e.concrete_inputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("sagan.")), key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(*args):
        raise AssertionError("span() opened a range with no profiler")

    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    off = span("feed")
    assert off is span("step", 3) is profiling._OFF
    with off, span("G"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).add_(1)
    assert _spans(prof) == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_call_nests_its_steps_phases_and_layers(case):
    step, state, images, labels = _state(case)
    state.step = 5   # a global step past 0
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        step(state, images, labels)
    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "sagan.train_step"]
    steps = [s for s in spans if s[0] == "sagan.step"]
    assert len(calls) == 1 and len(steps) == K
    assert [s[4] for s in steps] == [[5], [6]]
    phases = ["sagan." + p for p in MARKS[case][1:]]
    for one in steps:
        assert _inside(one, calls[0])
        got = [s for s in spans if s[0].removeprefix("sagan.")
               in step.SPANS and _inside(s, one)]
        assert [s[0] for s in got] == phases
        # each layer's span lies in a phase, in the net it belongs to
        for name, parents in (("sagan.G", ("sagan.fakes", "sagan.g_fwd_bwd")),
                              ("sagan.D", ("sagan.d_fwd_bwd",
                                           "sagan.g_fwd_bwd")),
                              ("sagan.sn", ("sagan.G", "sagan.D")),
                              ("sagan.attention", ("sagan.G", "sagan.D")),
                              ("sagan.attention.bwd", ("sagan.d_fwd_bwd",
                                                       "sagan.g_fwd_bwd"))):
            inner = [s for s in spans if s[0] == name and _inside(s, one)]
            assert inner, name
            assert all(any(p[0] in parents and _inside(s, p) for p in spans)
                       for s in inner), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_mark_is_called_as_before(case):
    step, state, images, labels = _state(case)
    marks = []
    step.mark = marks.append
    step(state, images, labels)
    assert marks == MARKS[case] * K


@pytest.mark.parametrize("device_cache", [True, False])
def test_one_feed_span_a_call_outside_the_train_step(tmp_path, device_cache):
    data = make_synthetic_dataset(str(tmp_path / "d"), num=8, img_size=16,
                                  num_classes=1, seed=1)
    trainer = Trainer(resolve_config(dict(
        CONFIG, data_path=data, steps_per_call=1, device_cache=device_cache,
        data_workers=1, log_dir=None, ckpt_dir=None, img_dir=None,
        fid_epoch_freq=0)), device="cpu")
    trainer._maybe_build_device_cache()
    assert (trainer._device_data is not None) == device_cache
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls = 0
        for images, labels in trainer._device_batches(0):
            trainer.train_step(trainer.state, images, labels)
            calls += 1
    spans = _spans(prof)
    feeds = [s for s in spans if s[0] == "sagan.feed"]
    steps = [s for s in spans if s[0] == "sagan.train_step"]
    assert calls == trainer.steps_per_epoch == 4
    assert len(feeds) == len(steps) == calls
    assert all(f[2] <= s[1] or s[2] <= f[1] for f in feeds for s in steps)


def test_a_step_computes_the_same_bits_under_the_profiler():
    runs = []
    for profiled in (False, True):
        step, state, images, labels = _state("update_ratio_1")
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                metrics = step(state, images, labels)
            assert _spans(prof)
        else:
            metrics = step(state, images, labels)
        runs.append((metrics, state))
    (m0, s0), (m1, s1) = runs
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for net in ("gen", "disc"):
        a, b = getattr(s0, net).state_dict(), getattr(s1, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), net
    assert all(torch.equal(s0.ema[k], s1.ema[k]) for k in s0.ema)
    for opt in ("opt_g", "opt_d"):
        a, b = getattr(s0, opt).state_dict(), getattr(s1, opt).state_dict()
        for i, row in a["state"].items():
            for k, v in row.items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(b["state"][i][k]))
    assert s0.step == s1.step == K
    assert np.isfinite(float(m0["G_loss"]))

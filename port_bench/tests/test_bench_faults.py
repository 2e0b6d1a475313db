"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped (CPU, tiny cells) and the rest
of a run drives the broken program: a step that leaves its state
unchanged, a step over half of its batch, D's update alone over half of
its batch, the attention's gradient into k and v doubled, an image
altered in the feed.  (One chip: there is no exchange between chips to
leave out.)  Both sides compute in fp32 here, so the tiny cell's limits
(``conftest.tiny_cell``) also hold the first gradients, which bf16 on the
card keeps too close to its fp8 control to hold (PERF.md section 2)."""

import time

import pytest
import torch

from conftest import VANILLA, tiny_cell
from port_bench.run import run_cell
from sagan_tpu_torch.nn import attention as nn_attention
from sagan_tpu_torch.train import trainer

CPU = torch.device("cpu")


def _run():
    return run_cell(tiny_cell(VANILLA), 2 ** 35 + 1, 0.5, False, CPU,
                    time.perf_counter())


def _unchanged(original):
    def one_step(self, state, images, labels, lat):
        saved = [{k: v.clone() for k, v in net.state_dict().items()}
                 for net in (state.gen, state.disc)]
        metrics = original(self, state, images, labels, lat)
        for net, s in zip((state.gen, state.disc), saved):
            net.load_state_dict(s)
        return metrics
    return one_step


def _half_batch(original):
    def one_step(self, state, images, labels, lat):
        h = images.shape[0] // 2
        lat = {"flip": None, "g": tuple(t[:h] for t in lat["g"]),
               "d": [tuple(t[:h] for t in zl) for zl in lat["d"]]}
        return original(self, state, images[:h], labels[:h], lat)
    return one_step


def _d_half_batch(original):
    def d_loss(self, disc, images, labels, fake, fake_labels):
        h = images.shape[0] // 2
        return original(self, disc, images[:h], labels[:h], fake[:h],
                        fake_labels[:h])
    return d_loss


def _attn_kv_x2(original):
    def attention(q, k, v, **kw):
        k, v = (t.detach() + 2.0 * (t - t.detach()) for t in (k, v))
        return original(q, k, v, **kw)
    return attention


def _altered_feed(original):
    def gathered(self, arrays):
        images, labels = original(self, arrays)
        images = images.clone()
        images[..., 5, 5, :] ^= 1
        return images, labels
    return gathered


PLANTS = {
    "unchanged": (trainer.TrainStep, "one_step", _unchanged),
    "half_batch": (trainer.TrainStep, "one_step", _half_batch),
    "d_half_batch": (trainer.TrainStep, "_d_loss", _d_half_batch),
    "attn_kv_x2": (nn_attention, "attention", _attn_kv_x2),
    "feed": (trainer.Trainer, "_gathered", _altered_feed),
}


@pytest.mark.parametrize("fault", list(PLANTS))
def test_training_fault_is_caught(monkeypatch, fault):
    owner, name, wrap = PLANTS[fault]
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    r = _run()
    assert r["correct"] is False
    if fault in ("d_half_batch", "attn_kv_x2"):
        key = "grad1_rel_D" if fault == "d_half_batch" else "grad1_rel_G"
        assert r["compared"][key]["value"] > r["compared"][key]["limit"]


def test_the_unbroken_run_is_correct():
    assert _run()["correct"] is True

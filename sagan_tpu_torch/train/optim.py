"""TTUR optimizer pair, port of ``sagan_tpu/train/optim.py``: one Adam per
net with β1 = 0, β2 = 0.999, eps = 1e-7 and its own learning rate, under
a staircase exponential decay.

``torch.optim.Adam`` with β1 = 0 applies optax's update rule: the step is
lr · m / (sqrt(v̂) + eps), eps added to the bias-corrected sqrt(v̂).  The
rate of an update is ``lr0 · rate^⌊t / period⌋`` with t the number of
updates the optimizer made before it; G's period is ``steps_per_epoch``,
D's ``steps_per_epoch × update_ratio`` (D updates ``update_ratio`` times
per step), so both decay once per epoch.
"""

from __future__ import annotations

import torch

BETAS = (0.0, 0.999)
EPS = 1e-7


class StaircaseDecay:
    """lr0 · rate^⌊t / period⌋ (optax ``exponential_decay`` with
    ``staircase=True``)."""

    def __init__(self, lr0: float, period: int, rate: float):
        self.lr0, self.period, self.rate = lr0, max(1, period), rate

    def __call__(self, t: int) -> float:
        return self.lr0 * self.rate ** (t // self.period)


def make_gan_optimizers(config: dict, params_g, params_d,
                        steps_per_epoch: int):
    """((Adam for G, its schedule), (Adam for D, its schedule))."""
    decay = config.get("decay_rate", 1.0)
    ratio = config.get("update_ratio", 1)
    sched_g = StaircaseDecay(config["lr_g"], steps_per_epoch, decay)
    sched_d = StaircaseDecay(config["lr_d"], steps_per_epoch * ratio, decay)
    opt_g = torch.optim.Adam(params_g, lr=sched_g(0), betas=BETAS, eps=EPS)
    opt_d = torch.optim.Adam(params_d, lr=sched_d(0), betas=BETAS, eps=EPS)
    return (opt_g, sched_g), (opt_d, sched_d)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr

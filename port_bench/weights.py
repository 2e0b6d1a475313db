"""The weights both sides get, made from the seed on the device in one
draw a net.

Every parameter and buffer the reference asks for (``reference.nets.spec``)
takes its slice of one uniform [-1, 1) draw from a ``torch.Generator`` on
the device: kernels glorot-uniform, the class embedding U(-0.05, 0.05),
biases U(-0.02, 0.02), BN gamma 1 + U(-0.1, 0.1) and beta U(-0.1, 0.1)
(per class for conditional BN), the attention gate sigma in [0.25, 0.75]
(a trained SAGAN's gate is far from its initial 0, and at 0 the
attention would not reach the output), SN's u a random unit vector, BN's
running mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from .reference.nets import spec


def _scale(shape, role):
    if role == "w":
        receptive = math.prod(shape[2:])
        return math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
    return {"embed": 0.05, "b": 0.02, "gamma": 0.1, "beta": 0.1,
            "sigma": 0.25, "u": 1.0}[role]


def seeded_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make_net(cfg: dict, which: str, seed: int, device) -> tuple:
    """({name: fp32 parameter}, {name: fp32 buffer}) of net ``which``
    ("G" or "D") from ``seed``."""
    roles = spec(cfg, which).roles
    draw = [(n, s, r) for n, (s, r) in roles.items()
            if r not in ("mean", "var")]
    total = sum(math.prod(s) for _, s, _ in draw)
    flat = torch.rand(total, generator=seeded_generator(device, seed),
                      device=device) * 2.0 - 1.0
    params, bufs = {}, {}
    at = 0
    for name, shape, role in draw:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape) * _scale(shape, role)
        at += n
        if role == "gamma":
            x = x + 1.0
        elif role == "sigma":
            x = x + 0.5
        elif role == "u":
            x = x / torch.linalg.vector_norm(x)
        (bufs if role == "u" else params)[name] = x.clone()
    for name, (shape, role) in roles.items():
        if role in ("mean", "var"):
            fill = 0.0 if role == "mean" else 1.0
            bufs[name] = torch.full(shape, fill, device=device)
    return params, bufs


def load_into(module: torch.nn.Module, params: dict, bufs: dict) -> None:
    """Copy the weights into a program net; its state dict must hold
    exactly these names and shapes."""
    state = {**params, **bufs}
    module.load_state_dict({k: v.detach() for k, v in state.items()},
                           strict=True)

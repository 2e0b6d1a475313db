"""GAN losses, port of ``sagan_tpu/ops/losses.py``: hinge and binary
cross-entropy from logits, each a plain fp32 mean over every element of
D's output (whatever its layout), so the values do not depend on the
batch size.  ``get_loss(name)`` returns the (G loss, D loss) pair."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _flat_mean(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean()


def hinge_g(d_fake: torch.Tensor) -> torch.Tensor:
    """L_G = -E[D(G(z))]."""
    return -_flat_mean(d_fake)


def hinge_d(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """L_D = E[relu(1 - D(x))] + E[relu(1 + D(G(z)))]."""
    return (_flat_mean(F.relu(1.0 - d_real.float()))
            + _flat_mean(F.relu(1.0 + d_fake.float())))


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    logits = logits.float()
    # stable: max(x, 0) - x z + log(1 + exp(-|x|))
    return torch.mean(torch.clamp(logits, min=0.0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def bce_g(d_fake: torch.Tensor) -> torch.Tensor:
    return _bce_logits(d_fake, 1.0)


def bce_d(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    return _bce_logits(d_real, 1.0) + _bce_logits(d_fake, 0.0)


LOSSES = {
    "hinge_loss": (hinge_g, hinge_d),
    "cross_entropy": (bce_g, bce_d),
}


def get_loss(name: str):
    """(G loss, D loss) selected by the config key ``loss``."""
    if name not in LOSSES:
        raise ValueError(f"Unsupported loss type: {name!r} "
                         f"(choose from {sorted(LOSSES)})")
    return LOSSES[name]

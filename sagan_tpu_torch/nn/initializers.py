"""Weight initializers with the TF-Keras defaults the JAX package uses
(``sagan_tpu/nn/initializers.py``): glorot-uniform kernels, zero biases,
ones/zeros norm parameters and L2-normalized normal SN vectors.  Each
draws from an explicit ``torch.Generator`` (CPU), so a model built from a
seed is the same model on every device.
"""

from __future__ import annotations

import math

import torch


def zeros(shape) -> torch.Tensor:
    return torch.zeros(shape)


def ones(shape) -> torch.Tensor:
    return torch.ones(shape)


def glorot_uniform(shape, rng: torch.Generator | None = None) -> torch.Tensor:
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)).  The two
    channel axes come first (Dense [in, out], conv OIHW or IOHW) and the
    rest is the receptive field; only the sum of the fans matters, so the
    order of the two channel axes does not."""
    shape = tuple(shape)
    receptive = math.prod(shape[2:])
    fans = (shape[0] + shape[1]) * receptive if len(shape) >= 2 \
        else 2 * shape[0]
    limit = math.sqrt(6.0 / fans)
    return (torch.rand(shape, generator=rng) * 2.0 - 1.0) * limit


def uniform(shape, rng: torch.Generator | None = None,
            scale: float = 0.05) -> torch.Tensor:
    """U(-scale, scale): Keras's embedding default."""
    return (torch.rand(tuple(shape), generator=rng) * 2.0 - 1.0) * scale


def l2_normal(shape, rng: torch.Generator | None = None) -> torch.Tensor:
    """Random normal, L2-normalized: the spectral-norm ``u`` init."""
    v = torch.randn(shape, generator=rng)
    return v / (torch.linalg.vector_norm(v) + 1e-12)

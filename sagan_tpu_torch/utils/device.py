"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``torch.device(name)``, ``cuda`` by default.  Raises when a CUDA
    device is asked for and there is none: the port never carries on
    quietly on the CPU; pass ``cpu`` to run there."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (device='cpu') "
            "to run on the CPU")
    return device

"""Training checkpoints in the port's own format: one ``torch.save`` file
per saved step, ``<dir>/ckpt-<step:08d>.pt``, holding the G and D state
dicts (parameters and buffers: SN ``u``, BN running stats), both Adam
states, the step, the EMA of G's parameters (or None) and ``meta`` (the
model geometry, so a checkpoint can be sampled without its dataset).

The port does not read the JAX package's Orbax checkpoints (nor they its
files); weights cross over as the JAX export npz (``convert.py``).

Each file is written under a temporary name and ``os.replace``d, so a
reader never sees half a checkpoint; the newest ``max_to_keep`` are kept,
and a restore takes the newest file that loads.
"""

from __future__ import annotations

import os
import pickle
import re

import torch

_NAME = re.compile(r"^ckpt-(\d{8})\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step:08d}.pt")

    def all_steps(self) -> list[int]:
        """Saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, payload: dict) -> str:
        """Write ``payload`` (tensors on any device, plain Python values)
        as step ``step``'s checkpoint; drop all but the newest
        ``max_to_keep``.  Returns the path."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore_step(self, step: int) -> dict:
        """The checkpoint of step ``step`` (tensors on the CPU); raises
        ``KeyError`` naming the saved steps when there is none."""
        if step not in self.all_steps():
            raise KeyError(f"no checkpoint at step {step}; available: "
                           f"{self.all_steps()}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore_latest(self) -> dict | None:
        """The newest checkpoint that loads (tensors on the CPU), or None
        when the directory has none."""
        for step in reversed(self.all_steps()):
            try:
                return torch.load(self.path(step), map_location="cpu",
                                  weights_only=True)
            except (OSError, RuntimeError, EOFError,
                    pickle.UnpicklingError) as err:
                print(f"checkpoint at step {step} is unreadable ({err}); "
                      f"trying the one before", flush=True)
        return None

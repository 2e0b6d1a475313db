"""Training checkpoints in the port's own format: one ``torch.save`` file
per saved step, ``<dir>/ckpt-<step:08d>.pt``, holding the G and D state
dicts (parameters and buffers: SN ``u``, BN running stats), both Adam
states, the step, the EMA of G's parameters (or None) and ``meta`` (the
model geometry, so a checkpoint can be sampled without its dataset).

The port does not read the JAX package's Orbax checkpoints (nor they its
files); weights cross over as the JAX export npz (``convert.py``).

Each file is written under a temporary name and ``os.replace``d, so a
reader never sees half a checkpoint; the newest ``max_to_keep`` are kept,
and a restore takes the newest file that loads, renaming each unreadable
one to ``<name>.corrupt`` (quarantine) so a later save of its step is not
shadowed by it.

Under a ``torch.distributed`` group the directory is shared: process 0
alone writes, renames and deletes; every process restores the same file
after a barrier, and a quarantine happens between barriers, as JAX's
``_quarantine`` does.
"""

from __future__ import annotations

import os
import pickle
import re

import torch

from ..parallel import mesh

_NAME = re.compile(r"^ckpt-(\d{8})\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.primary = mesh.process_index() == 0
        if self.primary:
            os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step:08d}.pt")

    def all_steps(self) -> list[int]:
        """Saved steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, payload: dict) -> str | None:
        """Write ``payload`` (tensors on any device, plain Python values)
        as step ``step``'s checkpoint; drop all but the newest
        ``max_to_keep``.  Returns the path (None on a process other than
        0, which writes nothing)."""
        if not self.primary:
            return None
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
        when the directory has none; each unreadable newer one is
        quarantined."""
        mesh.barrier()
        for step in reversed(self.all_steps()):
            try:
                return torch.load(self.path(step), map_location="cpu",
                                  weights_only=True)
            except (OSError, RuntimeError, EOFError,
                    pickle.UnpicklingError) as err:
                print(f"checkpoint at step {step} is unreadable ({err}); "
                      f"trying the one before", flush=True)
                self._quarantine(step)
        return None

    def _quarantine(self, step: int) -> None:
        """Rename step ``step``'s file to ``<name>.corrupt``: process 0
        alone, between barriers, so no process lists the step while
        another renames it."""
        mesh.barrier()
        if self.primary:
            dst = self.path(step) + ".corrupt"
            os.replace(self.path(step), dst)
            print(f"quarantined unreadable checkpoint step {step} -> {dst}",
                  flush=True)
        mesh.barrier()

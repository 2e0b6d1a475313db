"""Data parallelism over processes, the port's counterpart of
``sagan_tpu/parallel/mesh.py``: one process a card (PyTorch's idiom, where
a JAX process owns several chips), the processes joined by one
``torch.distributed`` group.

Parameters, buffers and optimizer states are replicated: every rank starts
from the same seeded init and applies the same mean gradients, so the
replicas stay equal bit for bit as long as every kernel is deterministic.
A training step mean-all-reduces each update's gradients, loss and health
(JAX's ``lax.pmean`` over ``data``) and every BN layer's moments
(cross-replica BN, through :func:`all_reduce_mean_grad`).

Without a group (one process, started without a launcher) nothing here
communicates: the counts are 1 and 0 and the reductions return their
input.  A launcher's one-rank group does communicate (a one-rank
all-reduce), so the group's own cost can be read on one card.

How the backends reduce:

* NCCL reduces on the card.
* gloo is a host backend: a CUDA tensor is copied to the host, reduced
  there and copied back (:func:`_all_reduce_`).  The backend is the
  caller's choice and is never switched on a failure.

The tensors of a step only ever meet ``all_reduce`` (gloo takes nothing
but ``all_reduce`` and ``broadcast`` on CUDA tensors).  Host values
(:func:`all_reduce_max`, :func:`barrier`) go through a gloo group on the
host, the default group under gloo and a second one under NCCL, so they
never wait for the card.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a rank that desyncs fails after this long instead of hanging (the
# group's start-up and every collective)
TIMEOUT = datetime.timedelta(seconds=60)

_host_twin = None   # the gloo twin of NCCL's default group, for host values


def initialize_distributed(backend: str, coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join this process to the group of ``num_processes`` (call once per
    process, before building the trainer).  ``coordinator``: an
    ``init_method`` such as ``tcp://localhost:29500`` (None: the
    launcher's ``MASTER_ADDR``/``MASTER_PORT``).  No-op when
    ``num_processes`` is None: one process without a launcher runs with
    no group at all."""
    if num_processes is None:
        return
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def shutdown_distributed() -> None:
    """Leave the group (and its host twin); no-op without one."""
    global _host_twin
    if not distributed():
        return
    if _host_twin is not None:
        dist.destroy_process_group(_host_twin)
        _host_twin = None
    dist.destroy_process_group()


def distributed() -> bool:
    """Whether this process belongs to a group."""
    return dist.is_available() and dist.is_initialized()


def backend() -> str | None:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return dist.get_backend() if distributed() else None


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def local_rank() -> int:
    """This process's index among the ranks of its host: the launcher's
    ``LOCAL_RANK``, else its rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device(name: str, backend: str | None = None) -> torch.device:
    """This rank's device for the CLI's ``--device``, chosen once, before
    the group starts: ``cuda`` without an index becomes
    ``cuda:<LOCAL_RANK>``; an explicit ``cuda:i`` is every local rank's
    card.  Raises when NCCL would put two ranks on one card (it refuses
    duplicate GPUs) or a rank has no card of its own; gloo lets ranks
    share one (``--device cuda:0``)."""
    device = torch.device(name)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    cards = torch.cuda.device_count()
    share = (f"; pass --dist_backend gloo --device cuda:0 to run "
             f"{local_world} ranks on one card")
    if device.index is None:
        if local_rank() >= cards:
            raise RuntimeError(
                f"rank {local_rank()} of this host has no card of its own "
                f"({local_world} ranks, {cards} cards){share}")
        return torch.device("cuda", local_rank())
    if backend == "nccl" and local_world > 1:
        raise RuntimeError(
            f"NCCL refuses two ranks on one card: --device {name} puts all "
            f"{local_world} ranks of this host on it{share}")
    return device


def _all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` in place; under gloo a CUDA tensor is reduced
    through a host copy."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op)
    return t


def all_reduce_mean(tensors) -> list:
    """``lax.pmean`` of ``tensors`` (one dtype): flattened into one buffer,
    summed over the ranks in one all-reduce, divided by the world size and
    cut back into views of their shapes.  Without a group, the input."""
    tensors = list(tensors)
    if not distributed():
        return tensors
    flat = _all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
    flat = flat.div_(process_count())
    out, begin = [], 0
    for t in tensors:
        out.append(flat[begin:begin + t.numel()].view_as(t))
        begin += t.numel()
    return out


class _MeanAllReduce(torch.autograd.Function):
    """The mean over the ranks, whose backward takes the mean of the
    cotangents over the ranks (``torch.distributed.nn.functional
    .all_reduce``'s rule, through :func:`_all_reduce_`)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone()).div_(process_count())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone()).div_(process_count())


def all_reduce_mean_grad(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: each rank's
    gradient then holds every rank's terms, so BN's moments of the global
    batch give the global batch's gradient.  Without a group, ``x``."""
    if not distributed():
        return x
    return _MeanAllReduce.apply(x)


def _host_group():
    """The group for host values: the default one under gloo, a gloo twin
    of it under NCCL (made by every rank at its first host reduction)."""
    global _host_twin
    if dist.get_backend() == "gloo":
        return None
    if _host_twin is None:
        _host_twin = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return _host_twin


def all_reduce_max(value: int) -> int:
    """The largest of the ranks' ``value``s, on the host.  Without a
    group, ``value``."""
    if not distributed():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return int(t.item())


def barrier() -> None:
    """Wait until every rank gets here (no-op without a group)."""
    if distributed():
        dist.barrier(group=_host_group())

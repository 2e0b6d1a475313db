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

Model parallelism (``model_parallel`` m > 1, JAX's ``make_mesh(n,
model_parallel=m)``): :func:`make_grid` lays the W ranks out as a (data,
model) grid of W/m x m, row-major as JAX's reshape of its devices, so
rank r has data index r // m and model index r % m.  The m ranks of one
data index (a model group) hold the column shards of the wide weights
(``parallel/sharding.py``) and run the same rows; the W/m ranks of one
model index (a data group) hold the same shard and run their own rows.
The gradient mean, BN's moments, the loss and the health reduce over the
data group (:func:`data_group`); a sharded layer gathers its output
channels over the model group (:func:`model_group`) with the three
autograd rules below.  Without a grid (or at m = 1) the data group is
the world and nothing changes.

How the backends reduce:

* NCCL reduces on the card.
* gloo is a host backend: a CUDA tensor is copied to the host, reduced
  there and copied back (:func:`all_reduce_`).  The backend is the
  caller's choice and is never switched on a failure.

The tensors of a step meet ``all_reduce`` and, under model parallelism,
``all_gather`` (gloo takes nothing but ``all_reduce`` and ``broadcast``
on CUDA tensors, so both go through host copies there).  Host values
(:func:`all_reduce_max`, :func:`barrier`) go through a gloo group on the
host, the default group under gloo and a second one under NCCL, so they
never wait for the card.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

# a rank that desyncs fails after this long instead of hanging (the
# group's start-up and every collective)
TIMEOUT = datetime.timedelta(seconds=60)

_host_twin = None   # the gloo twin of NCCL's default group, for host values
_grids: dict = {}   # the (data, model) grids made in this group, by m
_grid = None        # the grid in use (None: 1 x 1, or W x 1 data-parallel)


def whole_lines() -> None:
    """Make this process write each line of its stdout and stderr in one
    write: buffered until the line ends.  The ranks of a launcher share
    its stdout and stderr, and unbuffered (as under ``PYTHONUNBUFFERED``)
    a ``print`` is several writes (its text, each separator, the end), so
    another rank's line could land inside one; a line of at most
    ``PIPE_BUF`` (4,096) bytes written at once is never split."""
    for stream in (sys.stdout, sys.stderr):
        reconfigure = getattr(stream, "reconfigure", None)
        if reconfigure is not None:
            stream.flush()
            reconfigure(line_buffering=True, write_through=False)


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
    global _host_twin, _grid
    _grids.clear()
    _grid = None
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


def host_count() -> int:
    """The hosts of the group: the world over the launcher's
    ``LOCAL_WORLD_SIZE`` (1 without a launcher)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))
    return max(1, process_count() // max(1, local))


class _Grid:
    """The (data, model) grid of this rank: its indices and the groups of
    its model peers and of its data peers."""

    def __init__(self, m: int):
        world, rank = process_count(), process_index()
        if m < 1 or world % m:
            raise ValueError(
                f"model_parallel={m} must divide the group's {world} "
                f"ranks")
        self.m, self.count = m, world // m
        self.data_index, self.model_index = divmod(rank, m)
        self.model, self.data = None, None
        if m == 1:
            return   # W x 1: the data group is the world
        # every rank makes every group, in the same order (new_group is a
        # collective of the world), and keeps the two that hold it
        for d in range(self.count):
            group = dist.new_group([d * m + j for j in range(m)],
                                   timeout=TIMEOUT)
            if d == self.data_index:
                self.model = group
        for j in range(m):
            group = dist.new_group([d * m + j for d in range(self.count)],
                                   timeout=TIMEOUT)
            if j == self.model_index:
                self.data = group


def make_grid(model_parallel: int) -> None:
    """Lay the group's ranks out as a (data, model) grid of W/m x m
    (``model_parallel`` m) and use it.  Every rank calls it with the same
    m at the same point: a new m makes its groups, which every rank of
    the world must join; a grid made before is taken again.  Without a
    group, m must be 1."""
    global _grid
    if not distributed():
        if model_parallel != 1:
            raise ValueError(
                f"model_parallel={model_parallel} needs a group of ranks "
                f"(python -m torch.distributed.run --nproc_per_node W ...)"
                f"; one process runs model_parallel 1")
        _grid = None
        return
    if model_parallel not in _grids:
        _grids[model_parallel] = _Grid(model_parallel)
    _grid = _grids[model_parallel]


def model_size() -> int:
    """m, the ranks a sharded weight is cut over (1 without a grid)."""
    return _grid.m if _grid is not None else 1


def model_index() -> int:
    """This rank's place in its model group: which shard it holds."""
    return _grid.model_index if _grid is not None else 0


def data_count() -> int:
    """The data-parallel width, W/m: the number of distinct batches."""
    return _grid.count if _grid is not None else process_count()


def data_index() -> int:
    """Which of the ``data_count()`` batches (and data shards) this rank
    runs; its model peers run the same."""
    return _grid.data_index if _grid is not None else process_index()


def data_group():
    """The group the gradient mean, BN's moments, the loss and the health
    reduce over: this rank's data peers (None, the world, at m = 1)."""
    return _grid.data if _grid is not None else None


def model_group():
    """This rank's model peers (None when nothing is sharded)."""
    return _grid.model if _grid is not None else None


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


def _group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                 group=None) -> torch.Tensor:
    """``dist.all_reduce`` over ``group`` (None: the world) in place;
    under gloo a CUDA tensor is reduced through a host copy."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_mean(tensors, group=None) -> list:
    """``lax.pmean`` of ``tensors`` (one dtype) over ``group`` (None: the
    world): flattened into one buffer, summed over the ranks in one
    all-reduce, divided by the group's size and cut back into views of
    their shapes.  Without a group, the input."""
    tensors = list(tensors)
    if not distributed():
        return tensors
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]),
                        group=group)
    flat = flat.div_(_group_size(group))
    out, begin = [], 0
    for t in tensors:
        out.append(flat[begin:begin + t.numel()].view_as(t))
        begin += t.numel()
    return out


class _MeanAllReduce(torch.autograd.Function):
    """The mean over the group's ranks, whose backward takes the mean of
    the cotangents over them (``torch.distributed.nn.functional
    .all_reduce``'s rule, through :func:`all_reduce_`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group=group).div_(_group_size(group))

    @staticmethod
    def backward(ctx, grad):
        return (all_reduce_(grad.clone(), group=ctx.group)
                .div_(_group_size(ctx.group)), None)


def all_reduce_mean_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ranks (None: the world),
    differentiable: each rank's gradient then holds every rank's terms, so
    BN's moments of the global batch give the global batch's gradient.
    Without a group, ``x``."""
    if not distributed():
        return x
    return _MeanAllReduce.apply(x, group)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` over ``group`` concatenated along ``dim`` in rank
    order (``dist.all_gather``; under gloo a CUDA tensor goes through a
    host copy)."""
    n = _group_size(group)
    t = t.contiguous()
    host = t.is_cuda and dist.get_backend() == "gloo"
    src = t.cpu() if host else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device, non_blocking=True) if host else out


# The three rules of a column-parallel layer on the model group, whose
# compute after the gather is replicated over the model peers (each
# rank's autograd gives the gradient of the one global loss; a replicated
# tensor's cotangent is the whole one on every peer):
class _ToShards(torch.autograd.Function):
    """(a) A replicated tensor entering a sharded computation: identity
    forward; backward the sum of the peers' partial cotangents."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), group=model_group())


class _GatherShards(torch.autograd.Function):
    """(b) A sharded output gathered along ``dim``: all-gather forward;
    backward this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        return all_gather(x, dim, model_group())

    @staticmethod
    def backward(ctx, grad):
        begin = model_index() * ctx.size
        return grad.narrow(ctx.dim, begin, ctx.size).contiguous(), None


class _SumShards(torch.autograd.Function):
    """(c) The sum of the peers' partials, used replicated: sum
    all-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(), group=model_group())

    @staticmethod
    def backward(ctx, grad):
        return grad


def to_shards(x: torch.Tensor) -> torch.Tensor:
    return _ToShards.apply(x)


def gather_shards(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _GatherShards.apply(x, dim % x.dim())


def sum_shards(x: torch.Tensor) -> torch.Tensor:
    return _SumShards.apply(x)


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

"""Which parameters model parallelism shards, and the moves between whole
and sharded state: the port's counterpart of ``param_shardings``
(``sagan_tpu/parallel/mesh.py:70-93``).

JAX's rule, on the JAX shape of each variable: a leaf is column-sharded
over the model axis when its ndim is at least 2, its trailing
(output-feature) dim divides by m and it has at least ``MIN_SIZE``
elements; every other leaf is replicated.  The rule maps the same way over
the parameters, the Adam moments and the EMA.  The JAX trailing dim is, in
the port's layouts, the layer's output-channel axis: a Conv's OIHW dim 0,
a ConvTranspose's IOHW dim 1, a Dense's ``[in, out]`` and an Embedding's
``[classes, dim]`` dim 1, and conditional BN's gamma and beta tables
``[classes, C]`` dim 1.  SN's ``u``, biases, BN's vectors and the
attention gate are 1-D or scalars, so they stay whole on every rank.

A sharded layer holds this rank's slice of its weight (``sharded`` set on
the module) and gathers its output channels (``nn/layers.py``).  Its
state leaves the run whole: :func:`whole` gathers the shards over the
model group (a collective: every model peer calls it), :func:`local`
cuts a whole tensor to this rank's slice, so a checkpoint written at any
m restores at any other.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import ConditionalBatchNorm, _SNLayer
from . import mesh

MIN_SIZE = 4096   # param_shardings' min_size


def _axis(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The axis of ``module``'s parameter ``name`` that JAX's layout puts
    last."""
    if isinstance(module, _SNLayer) and name == "w":
        return module.out_dim % p.ndim
    if isinstance(module, ConditionalBatchNorm) and name in ("gamma",
                                                            "beta"):
        return 1
    raise ValueError(f"no JAX layout known for {type(module).__name__}."
                     f"{name} {tuple(p.shape)}")


def _params(root: nn.Module):
    """(qualified name, module, own name, parameter) of every parameter
    of ndim >= 2 under ``root``."""
    for mname, mod in root.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if p.ndim >= 2:
                yield (f"{mname}.{pname}" if mname else pname), mod, pname, p


def shard_axes(root: nn.Module, m: int, min_size: int = MIN_SIZE) -> dict:
    """{parameter name: axis} of the parameters of ``root`` that JAX's
    rule shards over a model axis of ``m`` (none at m = 1)."""
    if m <= 1:
        return {}
    axes = {}
    for name, mod, pname, p in _params(root):
        axis = _axis(mod, pname, p)
        if p.shape[axis] % m == 0 and p.numel() >= min_size:
            axes[name] = axis
    return axes


def shard_module(root: nn.Module) -> dict:
    """Cut every parameter of ``root`` that the rule picks for the current
    grid to this rank's slice of its output channels, in place, and mark
    its layer ``sharded``.  Returns {name: axis} of the cut parameters
    (empty at m = 1).  Call it on the whole, seeded init, before the
    optimizer sees the parameters."""
    axes = shard_axes(root, mesh.model_size())
    m, j = mesh.model_size(), mesh.model_index()
    modules = dict(root.named_modules())
    for name, axis in axes.items():
        mname, _, pname = name.rpartition(".")
        mod = modules[mname]
        if getattr(mod, "sn_backend", "xla") != "xla":
            raise ValueError(
                f"{name}: a sharded weight takes the plain SN (K7 would "
                f"normalize one shard as if it were the whole weight)")
        p = getattr(mod, pname)
        size = p.shape[axis] // m
        p.data = p.data.narrow(axis, j * size, size).clone()
        mod.sharded = True
    return axes


def sharded_axes(root: nn.Module) -> dict:
    """{parameter name: axis} of the parameters ``root`` holds as shards
    (those of its layers marked ``sharded``)."""
    return {name: _axis(mod, pname, p)
            for name, mod, pname, p in _params(root)
            if getattr(mod, "sharded", False)}


def whole(tensors: dict, axes: dict) -> dict:
    """``tensors`` by name, each named in ``axes`` gathered along its axis
    over the model group; the others as they are."""
    return {k: (mesh.all_gather(t, axes[k], mesh.model_group())
                if k in axes else t) for k, t in tensors.items()}


def local(tensors: dict, axes: dict) -> dict:
    """``tensors`` by name, each named in ``axes`` cut to this rank's
    slice along its axis; the others as they are."""
    m, j = mesh.model_size(), mesh.model_index()

    def cut(t, axis):
        size = t.shape[axis] // m
        return t.narrow(axis, j * size, size).clone()

    return {k: (cut(t, axes[k]) if k in axes else t)
            for k, t in tensors.items()}


def _optimizer_state(state_dict: dict, names: list, axes: dict,
                     move) -> dict:
    """An optimizer's ``state_dict`` (parameters indexed in ``names``
    order) with each sharded parameter's moments passed through
    ``move`` (their 0-d ``step`` as it is)."""
    state = {}
    for i, entry in state_dict["state"].items():
        name = names[i]
        if name not in axes:
            state[i] = entry
            continue
        state[i] = {k: (move({name: v}, axes)[name]
                        if torch.is_tensor(v) and v.ndim else v)
                    for k, v in entry.items()}
    return {**state_dict, "state": state}


def whole_optimizer(state_dict: dict, names: list, axes: dict) -> dict:
    return _optimizer_state(state_dict, names, axes, whole)


def local_optimizer(state_dict: dict, names: list, axes: dict) -> dict:
    return _optimizer_state(state_dict, names, axes, local)

"""Weight bridge between the JAX package's flat variable names and a port
module's ``state_dict`` (the generator, the discriminator or any layer).

The JAX export (``sagan_tpu.generate.export_generator_npz``) is a flat
``{"params/<path>": array, "aux/<path>": array, "meta/<key>": int}``
archive, and :func:`flat_from_jax_tree` flattens a JAX ``{"params",
"aux"}`` variable tree to the same names.  The port names its parameters
and buffers after the same tree, so ``params/up8_conv/w`` is the parameter
``up8_conv.w`` and ``aux/up8_bn/mean`` the buffer ``up8_bn.mean``; only
conv kernels change layout:

* Conv HWIO -> OIHW: ``permute(3, 2, 0, 1)``;
* ConvTranspose HWIO -> IOHW: ``permute(2, 3, 0, 1)``;
* Dense stays ``[in, out]``, Embedding ``[classes, dim]``; SN ``u``, BN
  mean/var and ``sigma`` copy over.
"""

from __future__ import annotations

import numpy as np
import torch

from .nn.layers import Conv, ConvTranspose

_META_KEYS = ("img_size", "num_classes", "z_dim")


def _layout(module: torch.nn.Module) -> dict:
    """{state key: permutation from the JAX layout to the port's}."""
    perms = {}
    for name, mod in module.named_modules():
        key = f"{name}.w" if name else "w"
        if isinstance(mod, ConvTranspose):
            perms[key] = (2, 3, 0, 1)
        elif isinstance(mod, Conv):
            perms[key] = (3, 2, 0, 1)
    return perms


def _jax_name(key: str, buffers) -> str:
    """The flat JAX name (``params/…`` or ``aux/…``) of state key ``key``
    of a module whose buffers are ``buffers``."""
    section = "aux" if key in buffers else "params"
    return f"{section}/{key.replace('.', '/')}"


def flat_from_jax_tree(variables) -> dict:
    """A JAX ``{"params": tree, "aux": tree}`` of nested dicts as flat
    ``{"params/<path>": np.ndarray, "aux/<path>": ...}``."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, child in node.items():
                walk(child, f"{prefix}/{k}")
        else:
            flat[prefix] = np.asarray(node)

    for section in ("params", "aux"):
        walk(variables.get(section, {}), section)
    return flat


def state_from_jax(flat, module: torch.nn.Module) -> dict:
    """``module``'s state dict from flat JAX names (a dict or an open
    ``np.load`` archive); every key the port needs must be present with
    the JAX shape."""
    perms = _layout(module)
    buffers = dict(module.named_buffers())
    state = {}
    for key, ref in module.state_dict().items():
        name = _jax_name(key, buffers)
        if name not in flat:
            raise KeyError(f"weights lack {name}: architecture mismatch "
                           f"with the supplied config")
        arr = torch.from_numpy(np.array(flat[name], np.float32))
        if key in perms:
            arr = arr.permute(perms[key])
        if arr.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(flat[name].shape)} does "
                             f"not fit {key} {tuple(ref.shape)}")
        state[key] = arr.contiguous().to(ref.dtype)
    return state


def jax_flat_from_module(module: torch.nn.Module) -> dict:
    """The inverse: ``module``'s weights as flat JAX-layout numpy arrays."""
    perms = _layout(module)
    buffers = dict(module.named_buffers())
    flat = {}
    for key, t in module.state_dict().items():
        t = t.detach().to("cpu", torch.float32)
        if key in perms:
            t = t.permute(tuple(np.argsort(perms[key])))
        flat[_jax_name(key, buffers)] = t.contiguous().numpy()
    return flat


def export_generator_npz(gen: torch.nn.Module, out_path: str,
                         config: dict | None = None) -> str:
    """Write ``gen`` in the JAX export's npz format, with the geometry
    (``meta/img_size`` etc.) when ``config`` is given; returns the path."""
    if not out_path.endswith(".npz"):
        out_path += ".npz"   # np.savez appends it anyway; return the truth
    arrays = jax_flat_from_module(gen)
    for k in _META_KEYS:
        if config and k in config:
            arrays[f"meta/{k}"] = np.asarray(int(config[k]))
    np.savez(out_path, **arrays)
    return out_path

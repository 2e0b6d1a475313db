"""Spectral normalization as a plain function (port of
``sagan_tpu/ops/spectral.py``).

Semantics of the reference, which ``torch.nn.utils.spectral_norm`` does
not have (it clamps the norm, keeps its own ``u`` and matricizes
``[c_out, -1]``):

* the kernel is matricized ``[fan_in, c_out]``, output channels as the
  columns, and ``u`` has shape ``[c_out]``;
* eps sits outside the norm: ``v / (||v|| + 1e-12)``, ``w / (sigma + eps)``;
* the iteration runs in fp32, with ``u`` and ``v`` carrying no gradient
  and sigma differentiable in W.

sigma does not depend on the order of W's rows, so a layer passes its
own layout and names the output-channel axis (``out_dim``).

``backend`` picks the implementation, as in the JAX package: ``"xla"``,
the plain function below (the JAX package computes that path outside any
Pallas kernel), or ``"pallas"``, the kernel K7 as a group of one through
:class:`~sagan_tpu_torch.ops.cuda_spectral.SpectralNormGroup` (a model
routed to K7 normalizes all its SN weights in one grouped call a forward:
``nn/layers.py`` :func:`set_sn_backend`).

A ``sharded`` weight (model parallelism, ``parallel/sharding.py``) holds
this model rank's columns W_s [fan_in, c_out/m] of the matricized kernel;
its SN is the whole weight's, as JAX's einsum SN on the model-sharded
array is, with scalar- and vector-sized sums over the model group:
v = l2n(Σ W_s u_s) (a [fan_in] sum), u_s = W_sᵀ v / ‖Wᵀ v‖ (the squared
norm summed), sigma = Σ v·W_s u_s (``mesh.sum_shards``, differentiable in
W_s, then ``mesh.to_shards``: W̄_s = W_s / sigma is sharded compute, so
sigma's cotangent is summed over the peers).  The new u is gathered, so
every model rank stores the whole u, equal to JAX's replicated one.
"""

from __future__ import annotations

import torch

from ..parallel import mesh
from .cuda_spectral import SpectralNormGroup


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def power_iterate(w_mat: torch.Tensor, u: torch.Tensor, n_iter: int = 1):
    """``n_iter`` power-iteration steps on ``w_mat`` [fan_in, c_out] from
    ``u`` [c_out].  Returns (sigma, u_new, v_new); u_new and v_new are
    detached."""
    if n_iter < 1:
        raise ValueError(f"power_iterate needs n_iter >= 1, got {n_iter}")
    w = w_mat.detach()
    u = u.detach()
    for _ in range(n_iter):
        v = _l2_normalize(w @ u)       # [fan_in]
        u = _l2_normalize(v @ w)       # [c_out]
    sigma = (v @ w_mat) @ u            # differentiable through w_mat
    return sigma, u, v


def _sharded_power_iterate(w_mat: torch.Tensor, u: torch.Tensor,
                           n_iter: int):
    """:func:`power_iterate` of the whole weight whose columns
    ``w_mat`` [fan_in, c_out/m] this model rank holds, ``u`` [c_out]
    whole.  Returns (sigma, whole u_new), sigma replicated and
    differentiable in ``w_mat``."""
    if n_iter < 1:
        raise ValueError(f"power_iterate needs n_iter >= 1, got {n_iter}")
    group = mesh.model_group()
    c = w_mat.shape[1]
    w = w_mat.detach()
    u = u.detach().narrow(0, mesh.model_index() * c, c)
    for _ in range(n_iter):
        v = _l2_normalize(mesh.all_reduce_(w @ u, group=group))
        t = v @ w
        sq = mesh.all_reduce_((t * t).sum().reshape(1), group=group)
        u = t / (torch.sqrt(sq[0]) + 1e-12)
    sigma = mesh.to_shards(mesh.sum_shards((v @ w_mat) @ u))
    return sigma, mesh.all_gather(u, 0, group)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, n_iter: int = 1,
                       eps: float = 1e-12, out_dim: int = -1,
                       backend: str = "xla", sharded: bool = False):
    """(w / (sigma + eps), u_new) for a kernel of any rank whose output
    channels lie on axis ``out_dim``; w_bar keeps w's shape and dtype.
    ``backend``: ``"xla"`` or ``"pallas"`` (K7).  ``sharded``: ``w`` is
    this model rank's shard of the output channels, ``u`` whole (plain
    SN only)."""
    if sharded:
        if backend != "xla":
            raise ValueError("a sharded weight takes the plain SN")
        w32 = w.float()
        w_mat = w32.movedim(out_dim, -1).reshape(-1, w.shape[out_dim])
        sigma, u_new = _sharded_power_iterate(w_mat, u.float(), n_iter)
        return (w32 / (sigma + eps)).to(w.dtype), u_new
    if backend == "pallas":
        # Every weight, of any size, goes through K7 on the card.  The JAX
        # package sends weights above VMEM_LIMIT_BYTES to its XLA path
        # (pallas_spectral.py:28,120-122), a TPU VMEM matter; a plain
        # route for large weights on a CUDA tensor would be a hidden
        # fallback.
        if n_iter < 1:
            raise ValueError(f"spectral_normalize needs n_iter >= 1, got "
                             f"{n_iter}")
        spec = ((u.float().contiguous(),), (n_iter,), (out_dim,), eps,
                torch.float32, (False,))
        w_bar, stats = SpectralNormGroup.apply(spec, w.float().contiguous())
        return w_bar.to(w.dtype), stats[:w.shape[out_dim]]
    if backend != "xla":
        raise ValueError(f"unknown SN backend {backend!r}")
    w32 = w.float()
    w_mat = w32.movedim(out_dim, -1).reshape(-1, w.shape[out_dim])
    sigma, u_new, _ = power_iterate(w_mat, u.float(), n_iter)
    return (w32 / (sigma + eps)).to(w.dtype), u_new

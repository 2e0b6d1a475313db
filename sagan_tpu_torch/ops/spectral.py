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
"""

from __future__ import annotations

import torch


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


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, n_iter: int = 1,
                       eps: float = 1e-12, out_dim: int = -1):
    """(w / (sigma + eps), u_new) for a kernel of any rank whose output
    channels lie on axis ``out_dim``; w_bar keeps w's shape and dtype."""
    w32 = w.float()
    w_mat = w32.movedim(out_dim, -1).reshape(-1, w.shape[out_dim])
    sigma, u_new, _ = power_iterate(w_mat, u.float(), n_iter)
    return (w32 / (sigma + eps)).to(w.dtype), u_new

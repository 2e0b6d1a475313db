"""The fused spectral norm K7: the wrapper of the hand-written CUDA kernel
``csrc/spectral_norm.cu``, the port of the TPU kernel
``sagan_tpu/ops/pallas_spectral.py::_sn_kernel``, its plain PyTorch
version, and :class:`SpectralNormFused`, the ``torch.autograd.Function``
that pairs it with the closed-form backward (``_sn_fwd`` / ``_sn_bwd`` of
the JAX package's custom VJP).

A weight is passed in its layer's own layout with its output channels on
axis ``out_dim`` and viewed as a contiguous ``[A, O, R]`` (:func:`sn_view`),
so the fan-in index is f = a·R + r and no copy matricizes it.

:func:`spectral_norm_fused` launches the kernel for tensors on the card
and raises on anything it does not take; it runs the plain version
(:func:`spectral_norm_reference`) only for tensors on the CPU.  There is
no fallback from a failed build or launch.  ``LAUNCHES`` counts the
kernel's launches (one a call, whatever ``n_iter``), so a run can show
that its spectral norms went through it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build

SOURCE = "spectral_norm"
LAUNCHES = 0


def build_specs() -> list:
    """``_build.build`` specs of the kernel: one library."""
    return [(SOURCE, ())]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.sagan_spectral_norm.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.sagan_spectral_norm.restype = ctypes.c_int
    lib.sagan_spectral_norm_blocks.argtypes = [ctypes.c_longlong] * 3
    lib.sagan_spectral_norm_blocks.restype = ctypes.c_longlong
    return lib


def sn_view(shape, out_dim: int) -> tuple[int, int, int]:
    """(A, O, R) of a weight of ``shape`` whose output channels lie on
    axis ``out_dim``: the axes before it, it, and the axes after it."""
    d = out_dim % len(shape)
    return math.prod(shape[:d]), shape[d], math.prod(shape[d + 1:])


def spectral_norm_reference(w: torch.Tensor, u: torch.Tensor, n_iter: int,
                            eps: float, out_dim: int):
    """The plain version: ``_sn_kernel``'s body in torch, fp32
    multiply-and-reduce in its order.  Returns (w_bar, u_new, v [F],
    sigma [])."""
    a, o, r = sn_view(w.shape, out_dim)
    w3 = w.float().reshape(a, o, r)
    u = u.float()
    for _ in range(n_iter):
        v = (w3 * u.view(1, o, 1)).sum(dim=1)              # [A, R]
        v = v / (torch.linalg.vector_norm(v) + eps)
        u2 = (w3 * v.view(a, 1, r)).sum(dim=(0, 2))        # [O]
        u = u2 / (torch.linalg.vector_norm(u2) + eps)
    sigma = (u2 * u).sum()
    return (w3 / (sigma + eps)).reshape(w.shape), u, v.reshape(-1), sigma


def _check(w: torch.Tensor, u: torch.Tensor, o: int) -> None:
    if w.device.type != "cuda" or u.device != w.device:
        raise ValueError(f"spectral_norm kernel needs w and u on one CUDA "
                         f"device, got {w.device} and {u.device}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"spectral_norm kernel takes float32 w and u, got "
                        f"{w.dtype} and {u.dtype}")
    if tuple(u.shape) != (o,):
        raise ValueError(f"spectral_norm kernel needs u [{o}], got "
                         f"{tuple(u.shape)}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("spectral_norm kernel needs contiguous w and u")


def spectral_norm_fused(w: torch.Tensor, u: torch.Tensor, n_iter: int = 1,
                        eps: float = 1e-12, out_dim: int = -1):
    """(w_bar, u_new, v, sigma) of ``n_iter`` power iterations from ``u``
    on the fp32 weight ``w`` (output channels on ``out_dim``): w_bar in w's
    shape, u_new [O], v [F] in the fan-in order f = a·R + r, sigma []."""
    global LAUNCHES
    if n_iter < 1:
        raise ValueError(f"spectral_norm needs n_iter >= 1, got {n_iter}")
    if w.device.type == "cpu" and u.device.type == "cpu":
        return spectral_norm_reference(w, u, n_iter, eps, out_dim)
    a, o, r = sn_view(w.shape, out_dim)
    _check(w, u, o)
    lib = _lib()
    opts = {"dtype": torch.float32, "device": w.device}
    w_bar = torch.empty_like(w)
    u_new = torch.empty(o, **opts)
    v = torch.empty(a * r, **opts)
    sigma = torch.empty((), **opts)
    # scratch: v_raw [F], the column sums [O] and the row blocks' partials
    blocks = lib.sagan_spectral_norm_blocks(a, o, r)
    scratch = torch.empty(a * r + o + blocks * o, **opts)
    v_raw, u2_raw, part = scratch.split((a * r, o, blocks * o))
    with torch.cuda.device(w.device):
        err = lib.sagan_spectral_norm(
            w.data_ptr(), u.data_ptr(), w_bar.data_ptr(), u_new.data_ptr(),
            v.data_ptr(), sigma.data_ptr(), v_raw.data_ptr(),
            u2_raw.data_ptr(), part.data_ptr(), a, o, r, n_iter, eps,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sagan_spectral_norm launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return w_bar, u_new, v, sigma


class SpectralNormFused(torch.autograd.Function):
    """(w_bar, u_new) = K7 of (w, u): forward :func:`spectral_norm_fused`,
    which keeps (w, u_new, v, sigma); backward the JAX package's
    ``_sn_bwd``, dW = g/s − (⟨g, W⟩/s²)·v uᵀ with s = sigma + eps, and no
    gradient to u."""

    @staticmethod
    def forward(ctx, w, u, n_iter, eps, out_dim):
        w_bar, u_new, v, sigma = spectral_norm_fused(w, u, n_iter, eps,
                                                     out_dim)
        ctx.save_for_backward(w, u_new, v, sigma)
        ctx.eps, ctx.out_dim = eps, out_dim
        ctx.mark_non_differentiable(u_new)
        return w_bar, u_new

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_u):
        w, u, v, sigma = ctx.saved_tensors
        a, o, r = sn_view(w.shape, ctx.out_dim)
        s = sigma + ctx.eps
        inner = (g * w).sum()
        outer = (v.view(a, 1, r) * u.view(1, o, 1)).reshape(w.shape)
        return g / s - (inner / (s * s)) * outer, None, None, None, None

"""Wrappers of the hand-written CUDA attention kernels and their autograd
Function:

* :func:`attention_fused`, the forward (``csrc/attention_fwd.cu``), the
  port of the TPU kernel ``sagan_tpu/ops/pallas_attention.py::_fwd_kernel``;
* :func:`attention_bwd_fused`, the backward (``csrc/attention_bwd.cu``),
  the port of ``_bwd_kernel``;
* :class:`FusedAttention`, the ``torch.autograd.Function`` whose forward
  is the first and whose backward is the second, as the JAX package's
  ``custom_vjp`` pairs them.

Each wrapper launches its kernel for tensors on the card and raises on
anything the kernel does not take; it runs the plain version
(:mod:`~sagan_tpu_torch.ops.attention`) only for tensors on the CPU.
There is no fallback from a failed build or launch.

``LAUNCHES`` and ``BWD_LAUNCHES`` count the kernels' launches, so a run
can show that its attention went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .attention import attention_bwd_reference, attention_reference

SOURCE = "attention_fwd"
BWD_SOURCE = "attention_bwd"
SUPPORTED_D = (2, 4, 8, 16, 32)
SUPPORTED_C = (8, 16, 32, 64, 128)
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
BWD_LAUNCHES = 0


def build_specs(widths=SUPPORTED_C, sources=(SOURCE, BWD_SOURCE)) -> list:
    """``_build.build`` specs of the kernels: one library per source and
    value width."""
    return [(src, (f"-DSAGAN_ATTN_C={c}",)) for src in sources
            for c in widths]


@functools.cache
def _entry(source: str, c: int):
    """The C entry point of ``source``'s library for value width ``c``."""
    lib = _build.load(*build_specs((c,), (source,))[0])
    if source == SOURCE:
        fn = lib.sagan_attention_fwd
        pointers, ints = 4, 6   # q, k, v, o; b, n, m, d, c, is_bf16
    else:
        fn = lib.sagan_attention_bwd
        pointers, ints = 8, 6   # q, k, v, g, dq, dk, dv, stats
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           g: torch.Tensor | None = None) -> None:
    named = {"q": q, "k": k, "v": v} | ({} if g is None else {"g": g})
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in named.values()):
        raise ValueError(
            f"attention kernel needs {', '.join(named)} on one CUDA device, "
            f"got {', '.join(str(t.device) for t in named.values())}")
    if q.dtype not in _IS_BF16 or any(t.dtype != q.dtype
                                      for t in named.values()):
        raise TypeError(
            f"attention kernel takes float32 or bfloat16 {', '.join(named)} "
            f"of one dtype, got "
            f"{', '.join(str(t.dtype) for t in named.values())}")
    if any(t.dim() != 3 for t in named.values()):
        raise ValueError("attention kernel takes q [B,N,D], k [B,M,D], "
                         "v [B,M,C] and g [B,N,C]")
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if k.shape != (b, m, d) or v.shape[0] != b or (
            g is not None and g.shape != (b, n, c)):
        raise ValueError(
            "attention shapes disagree: " + ", ".join(
                f"{name} {tuple(t.shape)}" for name, t in named.items()))
    if min(b, n, m) < 1 or b > 65535:
        raise ValueError(f"attention kernel needs 1 <= B <= 65535 and "
                         f"N, M >= 1, got B={b} N={n} M={m}")
    if d not in SUPPORTED_D or c not in SUPPORTED_C:
        raise ValueError(f"attention kernel is built for d in {SUPPORTED_D} "
                         f"and c in {SUPPORTED_C}, got d={d} c={c}")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError(
            f"attention kernel needs contiguous {', '.join(named)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def attention_fused(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v with unscaled logits.  q [B,N,D], k [B,M,D],
    v [B,M,C] -> [B,N,C] in q.dtype.  Not differentiable itself: the
    model calls it through :class:`FusedAttention`."""
    global LAUNCHES
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v)
    _check(q, k, v)
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    fn = _entry(SOURCE, c)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, m, d, c, _IS_BF16[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def attention_bwd_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor):
    """(dq, dk, dv) of softmax(q kᵀ) v at output cotangent g [B,N,C]:
    dq in q's dtype, dk and dv summed in fp32 and cast to k's and v's."""
    global BWD_LAUNCHES
    if _on_cpu(q, k, v, g):
        return attention_bwd_reference(q, k, v, g)
    _check(q, k, v, g)
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stats = torch.empty((3, b, n), dtype=torch.float32, device=q.device)
    fn = _entry(BWD_SOURCE, c)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats.data_ptr(), b, n, m, d, c, _IS_BF16[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """softmax(q kᵀ) v whose forward is :func:`attention_fused` and whose
    backward is :func:`attention_bwd_fused`; like the JAX custom VJP it
    keeps (q, k, v), not the softmax, and only when a gradient is
    needed."""

    @staticmethod
    def forward(ctx, q, k, v):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v)
        return attention_fused(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # the cotangent arrives as a view through the caller's
        # transpose/reshape; the kernel takes contiguous rows
        return attention_bwd_fused(q, k, v, g.contiguous())

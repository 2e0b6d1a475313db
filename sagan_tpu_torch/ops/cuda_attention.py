"""Wrapper of the hand-written CUDA attention forward
(``sagan_tpu_torch/csrc/attention_fwd.cu``), the port of the TPU kernel
``sagan_tpu/ops/pallas_attention.py::_fwd_kernel``.

:func:`attention_fused` launches the kernel for tensors on the card and
raises on anything the kernel does not take; it runs the plain version
(:func:`~sagan_tpu_torch.ops.attention.attention_reference`) only for
tensors on the CPU.  There is no fallback from a failed build or launch.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import attention_reference

SOURCE = "attention_fwd"
SUPPORTED_D = (2, 4, 8, 16, 32)
SUPPORTED_C = (8, 16, 32, 64, 128)
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0


def build_specs(widths=SUPPORTED_C) -> list:
    """``_build.build`` specs of the kernel: one library per value width."""
    return [(SOURCE, (f"-DSAGAN_ATTN_C={c}",)) for c in widths]


@functools.cache
def _entry(c: int):
    """The C entry point of the library for value width ``c``."""
    fn = _build.load(*build_specs((c,))[0]).sagan_attention_fwd
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            f"attention kernel needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _IS_BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"attention kernel takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention kernel takes q [B,N,D], k [B,M,D], "
                         "v [B,M,C]")
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if k.shape != (b, m, d) or v.shape[0] != b:
        raise ValueError(f"attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(b, n, m) < 1 or b > 65535:
        raise ValueError(f"attention kernel needs 1 <= B <= 65535 and "
                         f"N, M >= 1, got B={b} N={n} M={m}")
    if d not in SUPPORTED_D or c not in SUPPORTED_C:
        raise ValueError(f"attention kernel is built for d in {SUPPORTED_D} "
                         f"and c in {SUPPORTED_C}, got d={d} c={c}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel needs contiguous q, k, v")


def attention_fused(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v with unscaled logits.  q [B,N,D], k [B,M,D],
    v [B,M,C] -> [B,N,C] in q.dtype."""
    global LAUNCHES
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_reference(q, k, v)
    _check(q, k, v)
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    fn = _entry(c)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, m, d, c, _IS_BF16[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

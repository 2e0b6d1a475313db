"""SAGAN self-attention core op: ``softmax(Q Kᵀ) V`` over flattened
feature-map tokens.

Port of ``sagan_tpu/ops/attention.py``.  Plain PyTorch versions of the
forward and of its VJP, in JAX's layouts (q [B, N, D], k [B, M, D],
v [B, M, C]):

* :func:`attention_reference`, the forward: the test oracle, and what a
  CPU tensor runs;
* :func:`attention_bwd_reference`, the backward with the arithmetic of
  the TPU kernel ``pallas_attention.py::_bwd_kernel``: the oracle of the
  CUDA backward, and what a CPU tensor's gradient runs.

:func:`attention` goes through
:class:`sagan_tpu_torch.ops.cuda_attention.FusedAttention`, whose forward
and backward are the CUDA kernels for CUDA tensors (at every N: the JAX
package's ``N >= 256`` rule is a TPU tiling matter and does not carry
over) and the plain versions above for CPU tensors.

Logits are **unscaled** (no 1/sqrt(d)), per the original SAGAN.
"""

from __future__ import annotations

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Unfused oracle: fp32 logits and softmax, probabilities cast to
    ``v.dtype``, fp32 accumulation, output in ``q.dtype``."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv) of :func:`attention_reference` at output cotangent
    ``g`` [B, N, C], step for step as ``_bwd_kernel``: fp32 logits,
    E = exp(L − max), l⁻¹; dP = g Vᵀ and δ = Σ(E ⊙ dP) l⁻¹;
    dL = E ⊙ (dP − δ) l⁻¹, cast to k's type before the dQ and dK products;
    dV = Eᵀ (g l⁻¹) with both operands in v's type.  Products of
    same-typed operands accumulate in fp32; dq comes out in q's type, dk
    and dv are fp32 sums cast to k's and v's types."""
    f32 = torch.float32
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    linv = 1.0 / e.sum(dim=-1, keepdim=True)                # [B, N, 1]
    dp = torch.matmul(g.float(), v.float().transpose(1, 2))  # [B, N, M]
    delta = (e * dp).sum(dim=-1, keepdim=True) * linv
    dlog = (e * (dp - delta) * linv).to(k.dtype).to(f32)
    dq = torch.matmul(dlog, k.float())
    dk = torch.matmul(dlog.transpose(1, 2), q.float())
    e_v = e.to(v.dtype).to(f32)
    g_v = (g.float() * linv).to(v.dtype).to(f32)
    dv = torch.matmul(e_v.transpose(1, 2), g_v)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_pallas: bool | None = None) -> torch.Tensor:
    """The kernels for CUDA tensors, the plain versions for CPU tensors,
    forward and backward alike.

    ``use_pallas=False`` keeps the config key's JAX meaning: the plain
    path on any device, differentiated by autograd.  ``None`` and
    ``True`` take the kernels wherever the tensors lie on the card."""
    if use_pallas is False:
        return attention_reference(q, k, v)
    from .cuda_attention import FusedAttention
    return FusedAttention.apply(q, k, v)

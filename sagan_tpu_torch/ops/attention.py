"""SAGAN self-attention core op: ``softmax(Q Kᵀ) V`` over flattened
feature-map tokens.

Port of ``sagan_tpu/ops/attention.py``.  Two implementations of one
function, in JAX's layouts (q [B, N, D], k [B, M, D], v [B, M, C]):

* :func:`attention_reference`, plain PyTorch: the test oracle, and what a
  CPU tensor runs;
* :func:`sagan_tpu_torch.ops.cuda_attention.attention_fused`, the CUDA
  kernel: what a CUDA tensor runs, at every N (the JAX package's
  ``N >= 256`` rule is a TPU tiling matter and does not carry over).

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_pallas: bool | None = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.

    ``use_pallas=False`` keeps the config key's JAX meaning: the plain
    path, on any device.  ``None`` and ``True`` take the kernel wherever
    the tensors lie on the card."""
    if use_pallas is False:
        return attention_reference(q, k, v)
    from .cuda_attention import attention_fused
    return attention_fused(q, k, v)

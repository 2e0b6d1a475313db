"""SAGAN self-attention (non-local) block, port of
``sagan_tpu/nn/attention.py``.

  theta: SN 1x1 conv, c -> c/8                   (queries [B, N, c/8])
  phi:   SN 1x1 conv, c -> c/8, 2x2/2 max pool   (keys    [B, M, c/8])
  g:     SN 1x1 conv, c -> c/2, 2x2/2 max pool   (values  [B, M, c/2])
  o    = softmax(theta phiᵀ) g -> SN 1x1 conv c/2 -> c
  out  = x + sigma * o, sigma an fp32 scalar initialized to 0.

Tokens are flattened row-major over (H, W), as the JAX module's NHWC
reshape does, so the core op sees the same [B, N, D] arrays.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import attention
from ..utils.profiling import span
from .layers import Conv, max_pool


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> contiguous [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2).contiguous()


class SelfAttention(nn.Module):
    def __init__(self, c, sn=True, sn_iters=1, downsample=True,
                 dtype=torch.float32, use_pallas: bool | None = None,
                 qk_dim: int | None = None, v_dim: int | None = None,
                 rng=None):
        super().__init__()
        if c < 8:
            raise ValueError(f"attention needs >=8 channels, got {c}")
        self.qk_dim = c // 8 if qk_dim is None else qk_dim
        self.v_dim = c // 2 if v_dim is None else v_dim
        if self.qk_dim < 1 or self.v_dim < 1:
            raise ValueError(
                f"attention qk_dim/v_dim must be >=1, got "
                f"{self.qk_dim}/{self.v_dim}")
        self.downsample = downsample
        self.dtype = dtype
        self.use_pallas = use_pallas
        kw = dict(kernel=1, stride=1, sn=sn, sn_iters=sn_iters, dtype=dtype,
                  rng=rng)
        self.theta = Conv(c, self.qk_dim, **kw)
        self.phi = Conv(c, self.qk_dim, **kw)
        self.g = Conv(c, self.v_dim, **kw)
        self.out_proj = Conv(self.v_dim, c, **kw)
        self.sigma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        with span("attention"):
            b, _, h, w = x.shape
            q = _tokens(self.theta(x))
            k = self.phi(x)
            v = self.g(x)
            if self.downsample:
                k = max_pool(k)
                v = max_pool(v)
            o = attention(q, _tokens(k), _tokens(v),
                          use_pallas=self.use_pallas)
            o = o.transpose(1, 2).reshape(b, self.v_dim, h, w)
            o = self.out_proj(o)
            # the fp32 gate promotes the sum to fp32, as in JAX
            return (x.float() + self.sigma * o.float()).to(self.dtype)

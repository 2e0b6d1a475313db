"""'vanilla' SAGAN generator and discriminator, port of
``sagan_tpu/models/vanilla.py``.

G: z[B, z_dim] (+ one-hot label) -> SN-Dense -> [B, 4, 4, 16 gf] (NHWC, as
  the JAX stem reshapes it) -> NCHW -> log2(img/4) stages of
  SN-ConvT 4x4/2 (no bias) -> (conditional) BN -> LeakyReLU 0.1
  [-> self-attention where the side is in attn_dim_G] -> Conv 4x4 ->
  tanh in fp32 -> [B, 3, S, S] in the compute dtype.
D: [B, 3, S, S] -> log2(img/4) stages of SN-Conv 4x4/2 -> LeakyReLU 0.1
  [-> self-attention where the side is in attn_dim_D], channels df·2^p
  ascending; conditional head = projection (sum-pool -> SN-Dense(1) +
  <feat, SN-Embed(label)>) [B, 1], unconditional head = SN-Conv 4x4 'SAME'
  to one channel [B, 1, 4, 4] (JAX: [B, 4, 4, 1]); fp32 out.

G is built in eval mode, the mode serving wants; the trainer switches it
to training mode.  D is built in training mode, as ``nn.Module``s are.
With ``remat`` each stage (a ``blocks`` entry) runs under
``nn.layers.remat``, its activations recomputed in the backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import SelfAttention
from ..nn.layers import (BatchNorm, ConditionalBatchNorm, Conv, ConvTranspose,
                         Dense, Embedding, global_sum_pool, leaky_relu, remat)
from ..utils.profiling import span


def _power(img_size: int) -> int:
    """Number of up-sampling stages: 64 -> 4, 128 -> 5."""
    p = int(math.log2(img_size / 4))
    if 4 * 2 ** p != img_size:
        raise ValueError(f"img_size must be 4*2^k, got {img_size}")
    return p


def _attention(config, c, sn_iters, dtype, rng) -> SelfAttention:
    return SelfAttention(
        c, sn_iters=sn_iters, downsample=config.get("attn_downsample", True),
        dtype=dtype, use_pallas=config.get("use_pallas"),
        qk_dim=config.get("attn_qk_dim"), v_dim=config.get("attn_v_dim"),
        rng=rng)


class Generator(nn.Module):
    """Built in eval mode.  ``rng`` (a CPU ``torch.Generator``) draws the
    initial weights."""

    def __init__(self, config, rng: torch.Generator | None = None):
        super().__init__()
        c = config
        self.z_dim = c["z_dim"]
        self.img_size = c["img_size"]
        self.use_label = c.get("use_label", False)
        self.num_classes = c.get("num_classes", 1)
        self.use_cond_bn = c.get("use_cond_bn", False) and self.use_label
        self.dtype = getattr(torch, c.get("compute_dtype", "float32"))
        self.remat = bool(c.get("remat", False))
        gf = c["gf_dim"]
        sn_iters = c.get("sn_iters", 1)
        attn_at = set(c.get("attn_dim_G", [])) if c.get("use_attention") \
            else set()

        in_dim = self.z_dim + (self.num_classes if self.use_label else 0)
        self.gf0 = gf * 16
        self.stem = Dense(in_dim, 4 * 4 * self.gf0, sn=True,
                          sn_iters=sn_iters, dtype=self.dtype, rng=rng)
        self.blocks = []  # (convT, bn, attn or None), registered below
        cin, side = self.gf0, 4
        for p in reversed(range(_power(self.img_size))):
            cout = gf * 2 ** p
            side *= 2
            convt = ConvTranspose(cin, cout, kernel=4, stride=2,
                                  use_bias=False, sn=True, sn_iters=sn_iters,
                                  dtype=self.dtype, rng=rng)
            bn = (ConditionalBatchNorm(cout, self.num_classes,
                                       dtype=self.dtype)
                  if self.use_cond_bn else BatchNorm(cout, dtype=self.dtype))
            self.add_module(f"up{side}_conv", convt)
            self.add_module(f"up{side}_bn", bn)
            attn = None
            if side in attn_at:
                attn = _attention(c, cout, sn_iters, self.dtype, rng)
                self.add_module(f"attn{side}", attn)
            self.blocks.append((convt, bn, attn))
            cin = cout
        self.to_rgb = Conv(cin, 3, kernel=4, stride=1, use_bias=False,
                           dtype=self.dtype, rng=rng)
        self.eval()

    def forward(self, z, labels=None):
        with span("G"):
            x = z.to(self.dtype)
            if self.use_label:
                one_hot = F.one_hot(labels.long(), self.num_classes)
                x = torch.cat([x, one_hot.to(self.dtype)], dim=-1)
            x = self.stem(x)
            x = x.reshape(x.shape[0], 4, 4, self.gf0).permute(0, 3, 1, 2)
            for convt, bn, attn in self.blocks:
                def stage(x, labels, convt=convt, bn=bn, attn=attn):
                    x = convt(x)
                    x = bn(x, labels) if self.use_cond_bn else bn(x)
                    x = leaky_relu(x, 0.1)
                    return x if attn is None else attn(x)
                x = remat(stage, x, labels) if self.remat else stage(x, labels)
            x = self.to_rgb(x)
            return torch.tanh(x.float()).to(self.dtype)


class Discriminator(nn.Module):
    """``rng`` (a CPU ``torch.Generator``) draws the initial weights.
    There is no batch-coupled layer, so a real and a fake batch may share
    one forward."""

    def __init__(self, config, rng: torch.Generator | None = None):
        super().__init__()
        c = config
        self.img_size = c["img_size"]
        self.use_label = c.get("use_label", False)
        self.num_classes = c.get("num_classes", 1)
        self.dtype = getattr(torch, c.get("compute_dtype", "float32"))
        self.remat = bool(c.get("remat", False))
        df = c["df_dim"]
        sn_iters = c.get("sn_iters", 1)
        attn_at = set(c.get("attn_dim_D", [])) if c.get("use_attention") \
            else set()

        self.blocks = []  # (conv, attn or None), registered below
        cin, side = 3, self.img_size
        for p in range(_power(self.img_size)):
            cout = df * 2 ** p
            side //= 2
            conv = Conv(cin, cout, kernel=4, stride=2, sn=True,
                        sn_iters=sn_iters, dtype=self.dtype, rng=rng)
            self.add_module(f"down{side}_conv", conv)
            attn = None
            if side in attn_at:
                attn = _attention(c, cout, sn_iters, self.dtype, rng)
                self.add_module(f"attn{side}", attn)
            self.blocks.append((conv, attn))
            cin = cout
        if self.use_label:
            self.head = Dense(cin, 1, sn=True, sn_iters=sn_iters,
                              dtype=self.dtype, rng=rng)
            self.embed = Embedding(self.num_classes, cin, sn=True,
                                   sn_iters=sn_iters, dtype=self.dtype,
                                   rng=rng)
        else:
            self.head_conv = Conv(cin, 1, kernel=4, stride=1, sn=True,
                                  sn_iters=sn_iters, dtype=self.dtype,
                                  rng=rng)

    def forward(self, img, labels=None):
        with span("D"):
            x = img.to(self.dtype)
            for conv, attn in self.blocks:
                def stage(x, conv=conv, attn=attn):
                    x = leaky_relu(conv(x), 0.1)
                    return x if attn is None else attn(x)
                x = remat(stage, x) if self.remat else stage(x)
            if self.use_label:
                # projection discriminator (Miyato & Koyama 2018)
                feat = global_sum_pool(x)                       # [B, C] fp32
                logit = self.head(feat)                         # [B, 1]
                emb = self.embed(labels).float()
                proj = (feat * emb).sum(dim=1, keepdim=True)
                return logit.float() + proj
            return self.head_conv(x).float()                    # [B, 1, 4, 4]

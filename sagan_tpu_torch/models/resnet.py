"""'resnet' SAGAN family, port of ``sagan_tpu/models/resnet.py``: the
legacy ImageNet-128 ResNet G and D, repaired, at any 4·2^k image size.

G: z[B, z_dim] (+ one-hot label) -> SN-Dense -> [B, 4, 4, gf0] (NHWC, as
  the JAX stem reshapes it) -> NCHW -> log2(img/4) up blocks with channels
  gf·2^(power−1−i), each
    main:     (c)BN -> ReLU -> SN-ConvT 3x3/2 -> (c)BN -> ReLU -> SN-Conv 3x3
    shortcut: SN-ConvT 3x3/2
  [-> self-attention where the side is in attn_dim_G] -> BN -> ReLU ->
  SN-Conv 3x3 -> tanh in fp32 -> [B, 3, S, S] in the compute dtype.
D: OptimizedBlock (SN-Conv 3x3 -> ReLU -> SN-Conv 3x3/2, shortcut SN-Conv
  3x3/2), then pre-activation down blocks with channels df·2^i [->
  self-attention where the side is in attn_dim_D], one final block that
  keeps the size; conditional head = ReLU -> sum-pool -> SN-Dense(1) +
  <feat, SN-Embed(label)> [B, 1]; unconditional head = SN-Conv 4x4 'SAME'
  to one channel on the final block's output, with no ReLU, [B, 1, 4, 4];
  fp32 out.

Child names follow the JAX variable tree (``up{side}``, ``attn{side}``,
``down{side}``, ``final``, ``stem``, ``bn_out``, ``to_rgb``, ``head``,
``embed``, ``head_conv``), so ``convert.py`` maps them as they are.  G is
built in eval mode, D in training mode, and ``remat`` runs each ``blocks``
stage under ``nn.layers.remat``, as in ``models/vanilla.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (BatchNorm, ConditionalBatchNorm, Conv, ConvTranspose,
                         Dense, Embedding, global_sum_pool, remat)
from ..utils.profiling import span
from .vanilla import _attention, _power


class ResUpBlock(nn.Module):
    def __init__(self, cin, cout, num_classes=0, dtype=torch.float32,
                 sn_iters=1, rng=None):
        super().__init__()
        self.cond = num_classes > 0
        self.dtype = dtype

        def bn(c):
            return (ConditionalBatchNorm(c, num_classes, dtype=dtype)
                    if self.cond else BatchNorm(c, dtype=dtype))

        kw = dict(kernel=3, sn=True, sn_iters=sn_iters, dtype=dtype, rng=rng)
        self.bn1 = bn(cin)
        self.convt1 = ConvTranspose(cin, cout, stride=2, **kw)
        self.bn2 = bn(cout)
        self.conv2 = Conv(cout, cout, stride=1, **kw)
        self.convt_sc = ConvTranspose(cin, cout, stride=2, **kw)

    def forward(self, x, labels=None):
        def bn(m, h):
            return m(h, labels) if self.cond else m(h)

        h = self.convt1(F.relu(bn(self.bn1, x)))
        h = self.conv2(F.relu(bn(self.bn2, h)))
        return (h + self.convt_sc(x)).to(self.dtype)


class ResDownBlock(nn.Module):
    """Pre-activation residual down block."""

    def __init__(self, cin, cout, downsample=True, dtype=torch.float32,
                 sn_iters=1, rng=None):
        super().__init__()
        self.dtype = dtype
        stride = 2 if downsample else 1
        kw = dict(kernel=3, sn=True, sn_iters=sn_iters, dtype=dtype, rng=rng)
        self.conv1 = Conv(cin, cout, stride=1, **kw)
        self.conv2 = Conv(cout, cout, stride=stride, **kw)
        self.conv_sc = Conv(cin, cout, stride=stride, **kw)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(F.relu(x))))
        return (h + self.conv_sc(F.relu(x))).to(self.dtype)


class OptimizedBlock(nn.Module):
    """First D block, no pre-activation on the raw image."""

    def __init__(self, cin, cout, dtype=torch.float32, sn_iters=1, rng=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(kernel=3, sn=True, sn_iters=sn_iters, dtype=dtype, rng=rng)
        self.conv1 = Conv(cin, cout, stride=1, **kw)
        self.conv2 = Conv(cout, cout, stride=2, **kw)
        self.conv_sc = Conv(cin, cout, stride=2, **kw)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        return (h + self.conv_sc(x)).to(self.dtype)


class ResGenerator(nn.Module):
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
        power = _power(self.img_size)
        attn_at = set(c.get("attn_dim_G", [])) if c.get("use_attention") \
            else set()
        ncls = self.num_classes if self.use_cond_bn else 0

        in_dim = self.z_dim + (self.num_classes if self.use_label else 0)
        self.gf0 = gf * 2 ** (power - 1)
        self.stem = Dense(in_dim, 4 * 4 * self.gf0, sn=True,
                          sn_iters=sn_iters, dtype=self.dtype, rng=rng)
        self.blocks = []  # (block, attn or None), registered below
        cin, side = self.gf0, 4
        for i in range(power):
            cout = gf * 2 ** (power - 1 - i)
            side *= 2
            blk = ResUpBlock(cin, cout, ncls, self.dtype, sn_iters, rng)
            self.add_module(f"up{side}", blk)
            attn = None
            if side in attn_at:
                attn = _attention(c, cout, sn_iters, self.dtype, rng)
                self.add_module(f"attn{side}", attn)
            self.blocks.append((blk, attn))
            cin = cout
        self.bn_out = BatchNorm(cin, dtype=self.dtype)
        self.to_rgb = Conv(cin, 3, kernel=3, stride=1, sn=True,
                           sn_iters=sn_iters, dtype=self.dtype, rng=rng)
        self.eval()

    def forward(self, z, labels=None):
        with span("G"):
            x = z.to(self.dtype)
            if self.use_label:
                one_hot = F.one_hot(labels.long(), self.num_classes)
                x = torch.cat([x, one_hot.to(self.dtype)], dim=-1)
            x = self.stem(x)
            x = x.reshape(x.shape[0], 4, 4, self.gf0).permute(0, 3, 1, 2)
            for blk, attn in self.blocks:
                def stage(x, labels, blk=blk, attn=attn):
                    x = blk(x, labels) if self.use_cond_bn else blk(x)
                    return x if attn is None else attn(x)
                x = remat(stage, x, labels) if self.remat else stage(x, labels)
            x = self.to_rgb(F.relu(self.bn_out(x)))
            return torch.tanh(x.float()).to(self.dtype)


class ResDiscriminator(nn.Module):
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
        power = _power(self.img_size)
        attn_at = set(c.get("attn_dim_D", [])) if c.get("use_attention") \
            else set()

        def attention(side, ch):
            if side not in attn_at:
                return None
            attn = _attention(c, ch, sn_iters, self.dtype, rng)
            self.add_module(f"attn{side}", attn)
            return attn

        self.blocks = []  # (block, attn or None), registered below
        side = self.img_size // 2
        blk = OptimizedBlock(3, df, self.dtype, sn_iters, rng)
        self.add_module(f"down{side}", blk)
        self.blocks.append((blk, attention(side, df)))
        cin = df
        for i in range(1, power):
            cout = df * 2 ** i
            side //= 2
            blk = ResDownBlock(cin, cout, dtype=self.dtype, sn_iters=sn_iters,
                               rng=rng)
            self.add_module(f"down{side}", blk)
            self.blocks.append((blk, attention(side, cout)))
            cin = cout
        self.final = ResDownBlock(cin, cin, downsample=False, dtype=self.dtype,
                                  sn_iters=sn_iters, rng=rng)
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
            for blk, attn in self.blocks:
                def stage(x, blk=blk, attn=attn):
                    x = blk(x)
                    return x if attn is None else attn(x)
                x = remat(stage, x) if self.remat else stage(x)
            x = self.final(x)
            if self.use_label:
                # projection discriminator: ReLU before the pool, as the JAX
                # model does
                feat = global_sum_pool(F.relu(x))               # [B, C] fp32
                logit = self.head(feat)                         # [B, 1]
                emb = self.embed(labels).float()
                proj = (feat * emb).sum(dim=1, keepdim=True)
                return logit.float() + proj
            # no ReLU before the patch head: the reference applies it to the
            # final block's (pre-activation residual) output
            return self.head_conv(x).float()                    # [B, 1, 4, 4]

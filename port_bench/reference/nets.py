"""Plain reference of the SAGAN generators and discriminators, in fp32.

Written from the architecture (SAGAN, arXiv:1805.08318; the repository's
README and example configs), not from the program: functional code over
a dict of parameters and a dict of buffers keyed by the program's
state-dict names, so the benchmark hands both sides the same weights.

* Spectral norm: one power iteration from the stored u over the kernel
  matricized [fan_in, c_out], u and v carry no gradient, eps outside the
  norm, W / (sigma + eps); a net in training mode stores the new u.
* Conv 'SAME' (TF rule: the odd pad on the high side); transposed conv
  'SAME' (x stride), computed here as a stride-1 conv of the zero-dilated
  input with the flipped kernel.
* BatchNorm: eps 1e-3, biased batch variance, running stats
  0.99 old + 0.01 batch; conditional BN looks gamma and beta up per class.
* Self-attention: 1x1 SN convs theta (c/8), phi (c/8, 2x2 max pool),
  g (c/2, 2x2 max pool), softmax(theta phi^T) g unscaled over row-major
  tokens, 1x1 SN conv back to c, x + sigma * o.  The core runs in blocks
  of query rows (``attention.py``), so the 512 map fits.

``Precision("fp8")`` computes every product as fp8 training does (e4m3
operands, e5m2 gradients, per-tensor scales): the control that the
comparison must reject.

In ``Net(spec=True)`` mode, every parameter asked for is made on the
meta device and recorded with its role, and every product's forward
FLOPs are counted: ``flops.py`` and the weight maker read that.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attention import blocked_attention

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
SN_EPS = 1e-12


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = largest / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded to fp8 e5m2 (per-tensor
    scale) on its way back into the product."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Precision:
    """The products' precision: ``fp32`` (as given), or ``fp8`` as fp8
    training computes them: the forward's operands rounded to e4m3 and
    the gradients entering each product's backward to e5m2, each with a
    per-tensor scale to the format's largest finite value (the roundings
    pass gradients straight through)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _off(self, x) -> bool:
        return self.mode == "fp32" or x.device.type == "meta"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand."""
        if self._off(x):
            return x
        d = x.detach()
        return x + (_round(d, torch.float8_e4m3fn, 448.0) - d)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result, whose gradient the backward rounds."""
        if self._off(y) or not y.requires_grad:
            return y
        return _GradRound.apply(y)


def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def transpose_pads(kernel: int, stride: int) -> tuple:
    """(low, high) zero padding of the stride-dilated input for a 'SAME'
    transposed conv (output = input x stride)."""
    total = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return low, total - low


class Net:
    """One forward of a net: reads ``params`` and ``bufs`` by name,
    writes new SN u and BN running stats into ``bufs`` when
    ``training``."""

    def __init__(self, params=None, bufs=None, training=True,
                 prec: Precision | None = None, spec: bool = False,
                 attn_block_bytes: int = 2 << 30,
                 bn_momentum: float = BN_MOMENTUM,
                 attn_kv_grad: float = 1.0):
        self.p = params if params is not None else {}
        self.b = bufs if bufs is not None else {}
        self.training = training
        self.prec = prec or Precision()
        self.spec = spec
        self.roles = {}       # name -> (shape, role), in spec mode
        self.flops = {"conv": 0, "dense": 0, "attn": 0}
        self.attn_sites = []  # (B, N, M, d, c) per attention call
        self.attn_block_bytes = attn_block_bytes
        self.bn_momentum = bn_momentum
        # a planted fault of the control's readings: the attention's
        # gradient into k and v scaled by this (1: none)
        self.attn_kv_grad = attn_kv_grad

    # -- state -------------------------------------------------------------
    def _param(self, name, shape, role):
        if self.spec:
            self.roles[name] = (tuple(shape), role)
            return torch.zeros(shape, device="meta")
        return self.p[name]

    def _buf(self, name, shape, role):
        if self.spec:
            self.roles[name] = (tuple(shape), role)
            return torch.ones(shape, device="meta")
        return self.b[name]

    def sn_weight(self, name, shape, out_dim, sn=True, role="w"):
        w = self._param(name + ".w", shape, role)
        if not sn:
            return w
        cout = shape[out_dim]
        u = self._buf(name + ".u", (cout,), "u")
        w_mat = w.movedim(out_dim, -1).reshape(-1, cout)
        with torch.no_grad():
            v = _l2n(w_mat @ u)
            u_new = _l2n(v @ w_mat)
        sigma = (v @ w_mat) @ u_new
        if self.training and not self.spec:
            self.b[name + ".u"] = u_new
        return w / (sigma + SN_EPS)

    def _bias(self, name, y, cout, dims):
        b = self._param(name + ".b", (cout,), "b")
        return y + b.view((-1,) + (1,) * dims)

    # -- layers ------------------------------------------------------------
    def dense(self, name, x, cin, cout, sn=True, bias=True):
        w = self.sn_weight(name, (cin, cout), -1, sn)
        self.flops["dense"] += 2 * x.shape[0] * cin * cout
        y = self.prec.out(self.prec.q(x) @ self.prec.q(w))
        return self._bias(name, y, cout, 0) if bias else y

    def conv(self, name, x, cin, cout, k, s=1, sn=True, bias=True):
        w = self.sn_weight(name, (cout, cin, k, k), 0, sn)
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        y = self.prec.out(F.conv2d(
            F.pad(self.prec.q(x), (left, right, top, bottom)),
            self.prec.q(w), stride=s))
        self.flops["conv"] += 2 * y.numel() * cin * k * k
        return self._bias(name, y, cout, 2) if bias else y

    def conv_t(self, name, x, cin, cout, k, s=2, bias=True):
        w = self.sn_weight(name, (cin, cout, k, k), 1)
        b, _, h, wd = x.shape
        self.flops["conv"] += 2 * x.numel() * cout * k * k
        xq = self.prec.q(x)
        if s > 1:
            dil = xq.new_zeros((b, cin, (h - 1) * s + 1, (wd - 1) * s + 1))
            dil[:, :, ::s, ::s] = xq
        else:
            dil = xq
        lo, hi = transpose_pads(k, s)
        kern = self.prec.q(w).flip(2, 3).transpose(0, 1)
        y = self.prec.out(F.conv2d(F.pad(dil, (lo, hi, lo, hi)), kern))
        return self._bias(name, y, cout, 2) if bias else y

    def embed(self, name, ids, num, dim):
        w = self.sn_weight(name, (num, dim), -1, role="embed")
        return w[ids.long()]

    def bn(self, name, x, c, labels=None, num_classes=0):
        shape = (num_classes, c) if num_classes else (c,)
        gamma = self._param(name + ".gamma", shape, "gamma")
        beta = self._param(name + ".beta", shape, "beta")
        mean_b = self._buf(name + ".mean", (c,), "mean")
        var_b = self._buf(name + ".var", (c,), "var")
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(),
                              min=0.0)
            if not self.spec:
                m = self.bn_momentum
                self.b[name + ".mean"] = (m * mean_b
                                          + (1 - m) * mean.detach())
                self.b[name + ".var"] = m * var_b + (1 - m) * var.detach()
        else:
            mean, var = mean_b, var_b
        y = (x - mean.view(-1, 1, 1)) * torch.rsqrt(var + BN_EPS).view(
            -1, 1, 1)
        if num_classes:
            ids = labels.long()
            return y * gamma[ids][:, :, None, None] + beta[ids][:, :, None,
                                                              None]
        return y * gamma.view(-1, 1, 1) + beta.view(-1, 1, 1)

    def attention(self, name, x, c):
        d, cv = c // 8, c // 2
        b, _, h, w = x.shape
        q = self.conv(name + ".theta", x, c, d, 1)
        k = F.max_pool2d(self.conv(name + ".phi", x, c, d, 1), 2, 2)
        v = F.max_pool2d(self.conv(name + ".g", x, c, cv, 1), 2, 2)

        def tokens(t):
            return t.flatten(2).transpose(1, 2)

        if self.attn_kv_grad != 1.0:
            k, v = (t.detach() + self.attn_kv_grad * (t - t.detach())
                    for t in (k, v))
        n, m = h * w, k.shape[2] * k.shape[3]
        self.flops["attn"] += 2 * b * n * m * (d + cv)
        self.attn_sites.append((b, n, m, d, cv))
        if self.spec:
            o = torch.zeros((b, n, cv), device="meta")
        else:
            o = blocked_attention(self.prec.q(tokens(q)),
                                  self.prec.q(tokens(k)),
                                  self.prec.q(tokens(v)),
                                  self.attn_block_bytes,
                                  fp8=self.prec.mode == "fp8")
            o = self.prec.out(o)
        o = o.transpose(1, 2).reshape(b, cv, h, w)
        o = self.conv(name + ".out_proj", o, cv, c, 1)
        sigma = self._param(name + ".sigma", (), "sigma")
        return x + sigma * o


def _power(img_size: int) -> int:
    p = int(math.log2(img_size // 4))
    if 4 * 2 ** p != img_size:
        raise ValueError(f"img_size must be 4*2^k, got {img_size}")
    return p


def _attn_at(cfg, key):
    return set(cfg.get(key, [])) if cfg.get("use_attention") else set()


def _labels_in(cfg, net: Net, z, labels):
    if cfg.get("use_label"):
        if net.spec:
            return torch.zeros((z.shape[0], z.shape[1] + cfg["num_classes"]),
                               device="meta")
        return torch.cat([z, F.one_hot(labels.long(), cfg["num_classes"])
                          .to(z.dtype)], dim=-1)
    return z


def generator(cfg: dict, net: Net, z, labels):
    """G(z, labels) -> [B, 3, S, S] in [-1, 1]."""
    if cfg.get("model", "vanilla") == "resnet":
        return _res_g(cfg, net, z, labels)
    return _vanilla_g(cfg, net, z, labels)


def discriminator(cfg: dict, net: Net, x, labels):
    """D(x, labels) -> logits ([B, 1] projection head, [B, 1, 4, 4] patch
    head)."""
    if cfg.get("model", "vanilla") == "resnet":
        return _res_d(cfg, net, x, labels)
    return _vanilla_d(cfg, net, x, labels)


def _vanilla_g(cfg, net, z, labels):
    gf = cfg["gf_dim"]
    ncls = cfg.get("num_classes", 1)
    cond_bn = cfg.get("use_cond_bn") and cfg.get("use_label")
    x = _labels_in(cfg, net, z, labels)
    gf0 = gf * 16
    x = net.dense("stem", x, x.shape[1], 16 * gf0)
    x = x.reshape(x.shape[0], 4, 4, gf0).permute(0, 3, 1, 2)
    cin, side = gf0, 4
    attn = _attn_at(cfg, "attn_dim_G")
    for p in reversed(range(_power(cfg["img_size"]))):
        cout, side = gf * 2 ** p, side * 2
        x = net.conv_t(f"up{side}_conv", x, cin, cout, 4, 2, bias=False)
        x = net.bn(f"up{side}_bn", x, cout, labels,
                   ncls if cond_bn else 0)
        x = F.leaky_relu(x, 0.1)
        if side in attn:
            x = net.attention(f"attn{side}", x, cout)
        cin = cout
    x = net.conv("to_rgb", x, cin, 3, 4, 1, sn=False, bias=False)
    return torch.tanh(x)


def _vanilla_d(cfg, net, x, labels):
    df = cfg["df_dim"]
    attn = _attn_at(cfg, "attn_dim_D")
    cin, side = 3, cfg["img_size"]
    for p in range(_power(cfg["img_size"])):
        cout, side = df * 2 ** p, side // 2
        x = F.leaky_relu(net.conv(f"down{side}_conv", x, cin, cout, 4, 2),
                         0.1)
        if side in attn:
            x = net.attention(f"attn{side}", x, cout)
        cin = cout
    if cfg.get("use_label"):
        return _projection(cfg, net, x.sum(dim=(2, 3)), cin, labels)
    return net.conv("head_conv", x, cin, 1, 4, 1)


def _projection(cfg, net, feat, c, labels):
    logit = net.dense("head", feat, c, 1)
    emb = net.embed("embed", labels, cfg["num_classes"], c)
    return logit + (feat * emb).sum(dim=1, keepdim=True)


def _res_g(cfg, net, z, labels):
    gf = cfg["gf_dim"]
    power = _power(cfg["img_size"])
    cond = cfg.get("use_cond_bn") and cfg.get("use_label")
    ncls = cfg["num_classes"] if cond else 0
    x = _labels_in(cfg, net, z, labels)
    gf0 = gf * 2 ** (power - 1)
    x = net.dense("stem", x, x.shape[1], 16 * gf0)
    x = x.reshape(x.shape[0], 4, 4, gf0).permute(0, 3, 1, 2)
    cin, side = gf0, 4
    attn = _attn_at(cfg, "attn_dim_G")
    for i in range(power):
        cout, side = gf * 2 ** (power - 1 - i), side * 2
        blk = f"up{side}"
        h = F.relu(net.bn(f"{blk}.bn1", x, cin, labels, ncls))
        h = net.conv_t(f"{blk}.convt1", h, cin, cout, 3, 2)
        h = F.relu(net.bn(f"{blk}.bn2", h, cout, labels, ncls))
        h = net.conv(f"{blk}.conv2", h, cout, cout, 3, 1)
        x = h + net.conv_t(f"{blk}.convt_sc", x, cin, cout, 3, 2)
        if side in attn:
            x = net.attention(f"attn{side}", x, cout)
        cin = cout
    x = F.relu(net.bn("bn_out", x, cin))
    return torch.tanh(net.conv("to_rgb", x, cin, 3, 3, 1))


def _res_down(net, name, x, cin, cout, stride, pre_act=True):
    a = F.relu(x) if pre_act else x
    h = net.conv(f"{name}.conv1", a, cin, cout, 3, 1)
    h = net.conv(f"{name}.conv2", F.relu(h), cout, cout, 3, stride)
    return h + net.conv(f"{name}.conv_sc", a, cin, cout, 3, stride)


def _res_d(cfg, net, x, labels):
    df = cfg["df_dim"]
    power = _power(cfg["img_size"])
    attn = _attn_at(cfg, "attn_dim_D")
    side = cfg["img_size"] // 2
    x = _res_down(net, f"down{side}", x, 3, df, 2, pre_act=False)
    if side in attn:
        x = net.attention(f"attn{side}", x, df)
    cin = df
    for i in range(1, power):
        cout, side = df * 2 ** i, side // 2
        x = _res_down(net, f"down{side}", x, cin, cout, 2)
        if side in attn:
            x = net.attention(f"attn{side}", x, cout)
        cin = cout
    x = _res_down(net, "final", x, cin, cin, 1)
    if cfg.get("use_label"):
        return _projection(cfg, net, F.relu(x).sum(dim=(2, 3)), cin, labels)
    return net.conv("head_conv", x, cin, 1, 4, 1)


def spec(cfg: dict, which: str, batch: int = 1) -> Net:
    """A spec-mode forward of ``which`` ("G" or "D") at ``batch``: its
    ``roles`` (every parameter and buffer with shape and role) and its
    forward ``flops`` and ``attn_sites``."""
    net = Net(spec=True)
    s = cfg["img_size"]
    labels = torch.zeros((batch,), dtype=torch.long, device="meta")
    if which == "G":
        generator(cfg, net, torch.zeros((batch, cfg["z_dim"]), device="meta"),
                  labels)
    else:
        discriminator(cfg, net, torch.zeros((batch, 3, s, s), device="meta"),
                      labels)
    return net

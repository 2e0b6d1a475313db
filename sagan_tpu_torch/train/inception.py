"""InceptionV3 features and classifier, the port of
``sagan_tpu/train/inception.py``: the FID and Inception Score backbone
(``tf.keras.applications.InceptionV3``: a conv/BN stem, the inception
blocks mixed0..mixed10, 2048 features after a global mean), from the same
npz of weights as the JAX package (``export_weights_npz`` there).

Weights map by Keras's creation order: unit i of :data:`UNITS` takes
``kernel_i`` (HWIO), ``beta_i``, ``mean_i`` and ``var_i``; the forward
below walks the units in that order, as the JAX forward does.  Every
convolution is bias-free, and every BN is scale-free with eps 1e-3,
followed by a ReLU (Keras's ``conv2d_bn``).  Every 'SAME' convolution has
an odd kernel at stride 1, so padding (kh // 2, kw // 2) is TF's; the
others are 'VALID'.  NCHW throughout; branches concatenate on channels in
the JAX order.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _unit_table() -> tuple:
    """(kh, kw, cin, cout) of the 94 conv/BN units in creation order."""
    units = [(3, 3, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64),   # stem
             (1, 1, 64, 80), (3, 3, 80, 192)]
    cin = 192
    for pool in (32, 64, 64):                                  # mixed0-2
        units += [(1, 1, cin, 64),
                  (1, 1, cin, 48), (5, 5, 48, 64),
                  (1, 1, cin, 64), (3, 3, 64, 96), (3, 3, 96, 96),
                  (1, 1, cin, pool)]
        cin = 64 + 64 + 96 + pool
    units += [(3, 3, cin, 384),                                # mixed3
              (1, 1, cin, 64), (3, 3, 64, 96), (3, 3, 96, 96)]
    cin = 384 + 96 + cin
    for c in (128, 160, 160, 192):                             # mixed4-7
        units += [(1, 1, cin, 192),
                  (1, 1, cin, c), (1, 7, c, c), (7, 1, c, 192),
                  (1, 1, cin, c), (7, 1, c, c), (1, 7, c, c), (7, 1, c, c),
                  (1, 7, c, 192),
                  (1, 1, cin, 192)]
    units += [(1, 1, cin, 192), (3, 3, 192, 320),              # mixed8
              (1, 1, cin, 192), (1, 7, 192, 192), (7, 1, 192, 192),
              (3, 3, 192, 192)]
    cin = 320 + 192 + cin
    for _ in range(2):                                         # mixed9-10
        units += [(1, 1, cin, 320),
                  (1, 1, cin, 384), (1, 3, 384, 384), (3, 1, 384, 384),
                  (1, 1, cin, 448), (3, 3, 448, 384), (1, 3, 384, 384),
                  (3, 1, 384, 384),
                  (1, 1, cin, 192)]
        cin = 320 + 768 + 768 + 192
    return tuple(units)


UNITS = _unit_table()
NUM_UNITS = 94
FEATURES = 2048
CLASSES = 1000


def _fingerprint(path: str) -> str:
    """First-MB sha1 of the weights file: keys FID/IS stat caches to the
    weight bytes (the JAX package's tag)."""
    with open(path, "rb") as f:
        return hashlib.sha1(f.read(1 << 20)).hexdigest()[:8]


def load_weights_npz(path: str) -> list:
    """The units' weights as numpy arrays: [{"kernel" (HWIO), "beta",
    "mean", "var"}] in creation order."""
    with np.load(path) as data:
        return [{k: data[f"{k}_{i}"] for k in ("kernel", "beta", "mean",
                                                "var")}
                for i in range(NUM_UNITS)]


def write_random_weights_npz(path: str, seed: int = 0,
                             include_top: bool = True) -> None:
    """An npz of the JAX format holding random weights drawn from
    ``seed`` with numpy (He-scaled kernels, BN statistics near (0, 1)):
    no published network, only the shapes and the file format."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (kh, kw, cin, cout) in enumerate(UNITS):
        out[f"kernel_{i}"] = (rng.standard_normal((kh, kw, cin, cout))
                              * np.sqrt(2.0 / (kh * kw * cin))
                              ).astype(np.float32)
        out[f"beta_{i}"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        out[f"mean_{i}"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        out[f"var_{i}"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    if include_top:
        out["top_w"] = (rng.standard_normal((FEATURES, CLASSES))
                        / np.sqrt(FEATURES)).astype(np.float32)
        out["top_b"] = (0.1 * rng.standard_normal(CLASSES)).astype(
            np.float32)
    np.savez(path, **out)


class InceptionV3(nn.Module):
    """x [B, 3, H, W] in [-1, 1] (H, W >= 75) -> [B, 2048] pooled
    features, fp32."""

    def __init__(self, params: list):
        super().__init__()
        if len(params) != NUM_UNITS:
            raise ValueError(f"{len(params)} units, InceptionV3 has "
                             f"{NUM_UNITS}")
        for i, (unit, shape) in enumerate(zip(params, UNITS)):
            kernel = np.asarray(unit["kernel"], np.float32)
            if kernel.shape != shape:
                raise ValueError(f"unit {i}: kernel {kernel.shape}, the "
                                 f"graph takes {shape}")
            self.register_buffer(f"kernel{i}", torch.from_numpy(
                kernel).permute(3, 2, 0, 1).contiguous())   # HWIO -> OIHW
            for k in ("beta", "mean", "var"):
                self.register_buffer(f"{k}{i}", torch.from_numpy(
                    np.asarray(unit[k], np.float32)).view(1, -1, 1, 1))

    def _conv_bn(self, units, x, stride: int = 1, valid: bool = False):
        """The next unit of the iterator ``units`` on ``x``."""
        i = next(units)
        kh, kw = UNITS[i][:2]
        x = F.conv2d(x, getattr(self, f"kernel{i}"), stride=stride,
                     padding=0 if valid else (kh // 2, kw // 2))
        x = ((x - getattr(self, f"mean{i}"))
             * torch.rsqrt(getattr(self, f"var{i}") + 1e-3)
             + getattr(self, f"beta{i}"))
        return F.relu(x)

    @staticmethod
    def _avg(x):
        # 'SAME' 3x3/1 mean over the valid cells only (JAX's _pool)
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    @staticmethod
    def _max(x):
        return F.max_pool2d(x, 3, 2)   # 3x3/2 'VALID'

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        units = iter(range(NUM_UNITS))
        u = functools.partial(self._conv_bn, units)
        cat = torch.cat

        x = u(x.float(), 2, valid=True)                      # stem
        x = u(x, valid=True)
        x = u(x)
        x = self._max(x)
        x = u(x, valid=True)
        x = u(x, valid=True)
        x = self._max(x)

        for _ in range(3):                                   # mixed0-2
            b1 = u(x)
            b5 = u(u(x))
            b3 = u(u(u(x)))
            bp = u(self._avg(x))
            x = cat([b1, b5, b3, bp], 1)

        b3 = u(x, 2, valid=True)                             # mixed3
        bd = u(u(u(x)), 2, valid=True)
        x = cat([b3, bd, self._max(x)], 1)

        for _ in range(4):                                   # mixed4-7
            b1 = u(x)
            b7 = u(u(u(x)))
            bd = u(u(u(u(u(x)))))
            bp = u(self._avg(x))
            x = cat([b1, b7, bd, bp], 1)

        b3 = u(u(x), 2, valid=True)                          # mixed8
        b7 = u(u(u(u(x))), 2, valid=True)
        x = cat([b3, b7, self._max(x)], 1)

        for _ in range(2):                                   # mixed9-10
            b1 = u(x)
            b3 = u(x)
            b3 = cat([u(b3), u(b3)], 1)
            bd = u(u(x))
            bd = cat([u(bd), u(bd)], 1)
            bp = u(self._avg(x))
            x = cat([b1, b3, bd, bp], 1)

        if next(units, None) is not None:
            raise AssertionError("the graph left units unused")
        return x.mean(dim=(2, 3))


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of [B, 3, H, W] to [B, 3, size, size], as JAX's
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
    triangle kernel widened by the scale when it shrinks (antialias)."""
    if x.shape[2] == x.shape[3] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class InceptionV3Features(nn.Module):
    """FID feature extractor: resize to ``resize_to`` (299, the FID
    protocol), InceptionV3, 2048 pooled features [B, 2048]."""

    def __init__(self, weights_path: str, resize_to: int = 299):
        super().__init__()
        self.net = InceptionV3(load_weights_npz(weights_path))
        self.resize_to = resize_to
        self.cache_tag = f"inception{resize_to}_{_fingerprint(weights_path)}"

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        if self.resize_to:
            x = resize(x, self.resize_to)
        return self.net(x)


class InceptionV3Classifier(InceptionV3Features):
    """Inception Score backbone: the features, then the 1000-way Dense top
    of an npz exported with it (``top_w`` [2048, 1000], ``top_b``), then a
    softmax: class probabilities [B, 1000]."""

    def __init__(self, weights_path: str, resize_to: int = 299):
        super().__init__(weights_path, resize_to)
        with np.load(weights_path) as data:
            if "top_w" not in data:
                raise ValueError(
                    f"{weights_path} has no classifier top — re-export "
                    f"with export_weights_npz(include_top=True)")
            self.register_buffer("top_w", torch.from_numpy(
                np.asarray(data["top_w"], np.float32)))
            self.register_buffer("top_b", torch.from_numpy(
                np.asarray(data["top_b"], np.float32)))
        self.cache_tag = (f"inception_cls{resize_to}_"
                          f"{_fingerprint(weights_path)}")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = super().forward(images)
        return torch.softmax(feats @ self.top_w + self.top_b, dim=-1)

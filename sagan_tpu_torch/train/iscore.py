"""Inception Score, the port of ``sagan_tpu/train/iscore.py``:
IS = exp(E_x KL(p(y|x) || p(y))), the mean and standard deviation over
``splits`` equal parts (Salimans et al. 2016).

Classifiers follow ``fid.py``'s extractors: ``inception`` (the port's
InceptionV3 with the npz's 1000-way top) or the random-feature proxy
:class:`RandomFeatureClassifier`, the port's own (seeded ``torch``
kernels and head; ``from_arrays`` takes JAX's).  Classifiers are
``nn.Module``s taking float images [B, 3, H, W] in [-1, 1] and giving
class probabilities [B, C] on their device.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .fid import (PROXY_BACKEND, RandomConvFeatures, _arrays_tag,
                  trainer_sampler)


def inception_score_from_probs(probs: np.ndarray, splits: int = 10):
    """IS over a [N, C] class-probability matrix → (mean, std)."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for part in np.array_split(np.arange(n), min(splits, n)):
        p = probs[part]
        marginal = p.mean(axis=0, keepdims=True)
        kl = np.sum(p * (np.log(p + 1e-16) - np.log(marginal + 1e-16)),
                    axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


class RandomFeatureClassifier(nn.Module):
    """Proxy classifier: the random conv trunk and a fixed random softmax
    head, ``softmax(4 · f @ w)`` with w [dim, num_classes] ~ N(0, 1/dim)."""

    def __init__(self, img_size: int, num_classes: int = 1000,
                 dim: int = 256, seed: int = 42, trunk=None, w=None):
        super().__init__()
        self.trunk = trunk if trunk is not None else RandomConvFeatures(
            img_size, dim=dim, seed=seed)
        if w is None:
            rng = torch.Generator().manual_seed(seed + 1)
            w = torch.randn(dim, num_classes, generator=rng) / np.sqrt(dim)
        self.register_buffer("w", torch.tensor(np.asarray(w, np.float32)))
        self.cache_tag = f"{self.trunk.cache_tag}_cls{self.w.shape[1]}"

    @classmethod
    def from_arrays(cls, kernels, w, img_size: int = 0
                    ) -> "RandomFeatureClassifier":
        """The proxy on given HWIO kernels and head (``np.asarray`` of the
        JAX classifier's ``trunk.kernels`` and ``w``)."""
        trunk = RandomConvFeatures.from_arrays(kernels, img_size)
        cls_ = cls(img_size, trunk=trunk, w=w)
        cls_.cache_tag = f"{trunk.cache_tag}_cls{_arrays_tag([w])}"
        return cls_

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.trunk(images) @ self.w * 4.0, dim=-1)


def get_classifier(config: dict, device="cpu") -> nn.Module:
    """The IS classifier on ``device``.  Its ``backend`` attribute names
    what was built ("inception" or ``PROXY_BACKEND``): report that, not
    the config's intent, because ``inception_weights`` that are missing,
    unreadable or without a classifier top fall back to the proxy
    (loudly)."""
    weights = config.get("inception_weights")
    if weights:
        usable = False
        if os.path.exists(weights):
            try:
                # a truncated or corrupt npz takes the proxy fallback
                # instead of ending the training run at IS time
                with np.load(weights) as npz:
                    usable = "top_w" in npz
            except Exception as ex:   # whatever np.load raises on it
                print(f"WARNING: inception_weights={weights!r} is "
                      f"unreadable ({type(ex).__name__}: {ex})",
                      flush=True)
        if usable:
            from .inception import InceptionV3Classifier
            cls = InceptionV3Classifier(weights)
            cls.backend = "inception"
            return cls.to(device)
        print(f"WARNING: inception_weights={weights!r} is missing, "
              f"unreadable, or has no classifier top (top_w); falling "
              f"back to the random-feature PROXY classifier — the "
              f"resulting IS is not comparable to published Inception "
              f"Scores", flush=True)
    cls = RandomFeatureClassifier(config["img_size"])
    cls.backend = PROXY_BACKEND
    return cls.to(device)


def inception_score(sample_batch_fn, config, num_images: int = 5000,
                    batch_size: int = 64, splits: int = 10,
                    rng: torch.Generator | None = None, classifier=None):
    """IS of generated samples.  ``sample_batch_fn(rng, n)`` → float
    images [n, 3, S, S] in [-1, 1] on the classifier's device (the
    contract of ``fid.fake_stats``); full batches, sliced."""
    if classifier is None:
        classifier = get_classifier(config)
    probs = []
    with torch.inference_mode():
        for begin in range(0, num_images, batch_size):
            n = min(batch_size, num_images - begin)
            probs.append(classifier(sample_batch_fn(rng, batch_size))[:n])
    probs = torch.cat(probs)[:num_images].double().cpu().numpy()
    return inception_score_from_probs(probs, splits)


def inception_score_for_trainer(trainer, num_images: int | None = None,
                                classifier=None):
    config = trainer.config
    num_images = num_images or config.get("is_num_images",
                                          config.get("fid_num_images", 5000))
    if classifier is None:
        classifier = get_classifier(config, trainer.device)
    sample_batch, rng = trainer_sampler(trainer)
    return inception_score(sample_batch, config, num_images=num_images,
                           batch_size=config.get("batch_size", 64), rng=rng,
                           classifier=classifier)

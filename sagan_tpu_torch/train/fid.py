"""Fréchet Inception Distance, the port of ``sagan_tpu/train/fid.py``.

* The exact Fréchet distance |μ₁-μ₂|² + tr(Σ₁+Σ₂-2·(Σ₁Σ₂)^½), in numpy
  float64 (the JAX module's framework-free code, copied), with the
  matrix square root through the symmetric product Σ₁^½ Σ₂ Σ₁^½.
* Real-set statistics cached under ``.cache/`` by dataset, size, count,
  data view and extractor (and process, under a group of several: each
  process measures its own shard against the same seeded fakes),
  published atomically.
* Feature extractors: ``inception`` (``train/inception.py``, from a local
  npz of InceptionV3 weights) and the random-feature proxy
  :class:`RandomConvFeatures`.  The port draws the proxy's kernels from a
  seeded ``torch.Generator``, not JAX's ``PRNGKey(42)``, so its proxy is
  a network of its own: its ``cache_tag`` and ``backend`` say so, and a
  port proxy FID is never cached or reported beside a JAX one.
  ``from_arrays`` takes JAX's kernels, so both packages can run one
  network.

Extractors are ``nn.Module``s on the run's device: they take float images
[B, 3, H, W] in [-1, 1] and return features [B, dim] there, in fp32 (the
features feed statistics; the trainer and ``evaluate`` turn TF32 off).
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import _same_padding
from ..parallel import mesh

PROXY_BACKEND = "random_proxy_torch"


# -- Fréchet distance --------------------------------------------------------


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians, numerically robust for near-singular
    covariances (trace term via the symmetric product)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    vals = np.clip(np.linalg.eigvalsh(inner), 0.0, None)
    tr_sqrt = float(np.sum(np.sqrt(vals)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_sqrt)


def activation_stats(acts: np.ndarray):
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


# -- feature extractors -------------------------------------------------------


class RandomConvFeatures(nn.Module):
    """Deterministic random conv features (the proxy extractor): four
    3x3 stride-2 'SAME' convolutions, each followed by a leaky ReLU of
    slope 0.2, then each channel's mean and (population) standard
    deviation over the map, concatenated: [B, dim]."""

    def __init__(self, img_size: int, dim: int = 256, seed: int = 42,
                 kernels=None):
        """``kernels``: four HWIO arrays (JAX's layout) to use instead of
        drawing them from ``seed`` (normal, He-scaled, as JAX draws its
        own)."""
        super().__init__()
        self.img_size, self.dim = img_size, dim
        if kernels is None:
            rng = torch.Generator().manual_seed(seed)
            chans = [3, 32, 64, 128, dim // 2]
            kernels = [torch.randn(3, 3, chans[i], chans[i + 1],
                                   generator=rng)
                       * np.sqrt(2.0 / (3 * 3 * chans[i]))
                       for i in range(4)]
            self.cache_tag = f"torch_random{dim}s{seed}"
        else:
            self.cache_tag = f"torch_random{dim}_{_arrays_tag(kernels)}"
        for i, k in enumerate(kernels):
            w = torch.tensor(np.asarray(k, np.float32))
            self.register_buffer(f"kernel{i}", w.permute(3, 2, 0, 1)
                                 .contiguous())   # HWIO -> OIHW

    @classmethod
    def from_arrays(cls, kernels, img_size: int = 0) -> "RandomConvFeatures":
        """The proxy on given HWIO kernels (``np.asarray(ext.kernels[i])``
        of the JAX extractor)."""
        return cls(img_size, dim=2 * np.shape(kernels[-1])[-1],
                   kernels=kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(4):
            w = getattr(self, f"kernel{i}")
            top, bottom = _same_padding(x.shape[2], 3, 2)
            left, right = _same_padding(x.shape[3], 3, 2)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
            x = F.leaky_relu(x, 0.2)
        mean = x.mean(dim=(2, 3))
        std = x.std(dim=(2, 3), correction=0)
        return torch.cat([mean, std], dim=1)


def _arrays_tag(arrays) -> str:
    """Short sha1 of the arrays' bytes."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()[:8]


def get_extractor(config: dict, device="cpu") -> nn.Module:
    """The FID feature extractor on ``device``.  Its ``backend``
    attribute names what was built ("inception" or
    ``PROXY_BACKEND``): report that, not the config's intent, because
    ``fid_extractor='auto'`` with ``inception_weights`` that do not exist
    falls back to the proxy (loudly)."""
    kind = config.get("fid_extractor", "auto")
    weights = config.get("inception_weights")
    if kind in ("inception", "auto") and weights and os.path.exists(weights):
        from .inception import InceptionV3Features
        ext = InceptionV3Features(weights)
        ext.backend = "inception"
        return ext.to(device)
    if kind == "inception":
        raise FileNotFoundError(
            "fid_extractor='inception' needs config['inception_weights'] "
            "pointing at a local weights file (no network egress here)")
    if weights and kind == "auto":
        # (fid_extractor='random' with a weights file kept for IS is a
        # choice, not a fallback: no warning)
        print(f"WARNING: inception_weights={weights!r} does not exist; "
              f"falling back to the random-feature PROXY extractor — the "
              f"resulting FID is not comparable to published numbers",
              flush=True)
    ext = RandomConvFeatures(config["img_size"],
                             dim=config.get("fid_feature_dim", 256))
    ext.backend = PROXY_BACKEND
    return ext.to(device)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.buffers()).device


# -- end-to-end FID -----------------------------------------------------------


def to_float_images(images_u8: np.ndarray, device) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> float [B, 3, S, S] in [-1, 1] on ``device``
    (the JAX package's ``x * (2 / 255) - 1``, in fp32)."""
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    return x.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0


def real_stats(dataset, extractor, num_images: int, cache_file: str | None):
    """(mu, sigma) of the first ``num_images`` records of the dataset's
    epochs 0, 1, ... (read from ``cache_file`` when it exists)."""
    if cache_file and os.path.isfile(cache_file):
        # the program's own cache, written below
        with open(cache_file, "rb") as f:
            return pickle.load(f, encoding="latin1")
    device = _device_of(extractor)
    acts = []
    seen = 0
    epoch = 0
    with torch.inference_mode():
        while seen < num_images:
            seen_before = seen
            for images_u8, _labels in dataset.epoch(epoch):
                acts.append(extractor(to_float_images(images_u8, device)))
                seen += images_u8.shape[0]
                if seen >= num_images:
                    break
            if seen == seen_before:
                # an epoch that yields nothing would spin this loop forever
                raise ValueError(
                    f"dataset produced no batches in epoch {epoch} — cannot "
                    f"accumulate {num_images} real images for FID (dataset "
                    f"smaller than one batch?)")
            epoch += 1
    stats = activation_stats(
        torch.cat(acts)[:num_images].double().cpu().numpy())
    if cache_file:
        os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
        # atomic publish: concurrent writers (or a crash mid-dump) must
        # never leave a torn pickle that poisons every later run
        tmp = f"{cache_file}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(stats, f)
        os.replace(tmp, cache_file)
    return stats


def fake_stats(sample_batch_fn, extractor, num_images: int, batch_size: int,
               rng: torch.Generator | None = None):
    """(mu, sigma) of ``num_images`` samples.  ``sample_batch_fn(rng, n)``
    -> float images [n, 3, S, S] in [-1, 1] on the extractor's device.
    Every batch is sampled full and sliced, as in JAX (whose remainder
    batch would compile anew)."""
    acts = []
    with torch.inference_mode():
        for begin in range(0, num_images, batch_size):
            n = min(batch_size, num_images - begin)
            acts.append(extractor(sample_batch_fn(rng, batch_size))[:n])
    return activation_stats(
        torch.cat(acts)[:num_images].double().cpu().numpy())


def cache_path(config: dict, num_images: int, cache_tag: str) -> str:
    """``.cache/{name}_{img_size}_{n}_d{data_size}s{data_seed}_{tag}.pkl``,
    JAX's key: the dataset's name (a sha1 of its path when unset), the
    data view (truncation and shuffle seed pick the first ``n`` records)
    and the extractor; with several data shards also ``_p{index}``, as
    JAX's ``_p{process_index}``: each process reads its own shard, so
    their real statistics must not share a file.  The index is the data
    index (the process index without model parallelism): model peers read
    the same shard and write the same file, each atomically."""
    name = config.get("dataset")
    if not name:
        # two datasets evaluated from one working directory must not
        # share cached real statistics
        path = os.path.abspath(str(config.get("data_path", "data")))
        name = "data_" + hashlib.sha1(path.encode()).hexdigest()[:10]
    view = f"d{config.get('data_size', -1)}s{config.get('data_seed', 0)}"
    if mesh.data_count() > 1:
        view += f"_p{mesh.data_index()}"
    return os.path.join(".cache", f"{name}_{config['img_size']}_"
                                  f"{num_images}_{view}_{cache_tag}.pkl")


def compute_fid(dataset, sample_batch_fn, config, num_images: int = 5000,
                batch_size: int = 64, rng: torch.Generator | None = None,
                extractor=None) -> float:
    """FID of ``sample_batch_fn``'s samples against the dataset's first
    ``num_images`` records."""
    if extractor is None:
        extractor = get_extractor(config)
    cache_file = cache_path(config, num_images, extractor.cache_tag)
    mu_r, s_r = real_stats(dataset, extractor, num_images, cache_file)
    mu_f, s_f = fake_stats(sample_batch_fn, extractor, num_images,
                           batch_size, rng)
    return frechet_distance(mu_f, s_f, mu_r, s_r)


def trainer_sampler(trainer):
    """(``sample_batch_fn(rng, n)`` of the trainer's evaluation G, and the
    seeded generator it draws z and labels from).  Labels are uniform
    over max(1, num_classes); FID and IS draw the same latents, as JAX's
    do (both start from ``PRNGKey(0)``)."""
    from .trainer import _EVAL, seeded

    config = trainer.config
    z_dim = config["z_dim"]
    num_classes = max(1, config.get("num_classes", 1))
    gen = trainer.eval_generator()
    device = trainer.device

    def sample_batch(rng, n):
        z = torch.randn(n, z_dim, device=device, generator=rng)
        labels = torch.randint(0, num_classes, (n,), device=device,
                               generator=rng)
        return gen(z, labels).float()

    return sample_batch, seeded(device, config.get("seed", 0), 0, _EVAL)


def compute_fid_for_trainer(trainer, num_images: int | None = None,
                            extractor=None) -> float:
    config = trainer.config
    num_images = num_images or config.get("fid_num_images", 5000)
    if extractor is None:
        extractor = get_extractor(config, trainer.device)
    sample_batch, rng = trainer_sampler(trainer)
    return compute_fid(trainer.ds_train, sample_batch, config,
                       num_images=num_images,
                       batch_size=config.get("batch_size", 64), rng=rng,
                       extractor=extractor)

"""The port's evaluation (``train/fid.py``, ``train/iscore.py``) against
the JAX package's on the same numpy inputs: the Fréchet distance and the
activation statistics (1e-9 relative), the random-feature proxy with
JAX's kernels carried across (features 1e-5 of max|f|, at even and odd
sizes, whose TF 'SAME' pads 0 before and 1 after; classifier
probabilities 1e-6), the Inception Score (1e-9), ``compute_fid`` on
identical images and records (1e-4 relative), the cache key and its
atomic publish, the backends chosen on the fallback paths, and the slice
as a whole: JAX's small vanilla G and ``compute_fid`` against the port's
G (weights converted) and ``compute_fid`` (FID within 1e-3 relative)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.data.loader import ImageDataset as JaxDataset
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.train import fid as jax_fid
from sagan_tpu.train import iscore as jax_iscore
from sagan_tpu.utils.config import load_config_file
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch.convert import state_from_jax
from sagan_tpu_torch.data.loader import ImageDataset
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.models import get_generator
from sagan_tpu_torch.train import fid, iscore
from sagan_tpu_torch.train.inception import write_random_weights_npz
from sagan_tpu_torch.utils.config import resolve_config

from test_torch_generator import perturbed_export


def _nchw(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(images).permute(0, 3, 1, 2)


def _images(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def test_frechet_distance_and_stats_are_jax_s():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((200, 16)) @ rng.standard_normal((16, 16))
    b = 0.5 + rng.standard_normal((150, 16)) @ rng.standard_normal((16, 16))
    stats = [fid.activation_stats(a), fid.activation_stats(b)]
    want = [jax_fid.activation_stats(a), jax_fid.activation_stats(b)]
    for (mu, sigma), (wmu, wsigma) in zip(stats, want):
        np.testing.assert_allclose(mu, wmu, rtol=1e-9)
        np.testing.assert_allclose(sigma, wsigma, rtol=1e-9)
    got = fid.frechet_distance(*stats[0], *stats[1])
    assert got > 1 and got == pytest.approx(
        jax_fid.frechet_distance(*want[0], *want[1]), rel=1e-9)
    assert fid.frechet_distance(*stats[0], *stats[0]) == pytest.approx(
        0.0, abs=1e-6)


@pytest.mark.parametrize("size", [32, 64, 33])
def test_proxy_features_on_jax_s_kernels(size):
    ref = jax_fid.RandomConvFeatures(size)
    ext = fid.RandomConvFeatures.from_arrays(
        [np.asarray(k) for k in ref.kernels])
    x = _images(size, 4, size)
    want = ref(x)
    with torch.no_grad():
        got = ext(_nchw(x)).numpy()
    assert got.shape == want.shape == (4, 256)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_proxy_classifier_probabilities_on_jax_s_head():
    ref = jax_iscore.RandomFeatureClassifier(32)
    cls = iscore.RandomFeatureClassifier.from_arrays(
        [np.asarray(k) for k in ref.trunk.kernels], np.asarray(ref.w))
    x = _images(7, 8, 32)
    want = ref(x)
    with torch.no_grad():
        got = cls(_nchw(x)).numpy()
    assert got.shape == want.shape == (8, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inception_score_from_probs_is_jax_s():
    logits = 3 * np.random.default_rng(1).standard_normal((101, 20))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (10, 3):
        got = iscore.inception_score_from_probs(probs, splits)
        want = jax_iscore.inception_score_from_probs(probs, splits)
        np.testing.assert_allclose(got, want, rtol=1e-9)
    assert got[0] > 1.5


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_ds")
    return make_synthetic_dataset(str(d), num=64, img_size=32,
                                  num_classes=1, seed=3, num_shards=2)


def _fid_config(data):
    return {"dataset": "synthetic", "data_path": data, "img_size": 32,
            "data_size": -1, "data_seed": 0}


def _proxy_pair(size):
    ref = jax_fid.RandomConvFeatures(size)
    return ref, fid.RandomConvFeatures.from_arrays(
        [np.asarray(k) for k in ref.kernels])


def test_compute_fid_on_identical_images_and_records(tmp_path, records,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    ref, ext = _proxy_pair(32)
    fakes = [_images(10 + i, 16, 32) for i in range(3)]
    config = _fid_config(records)

    def jax_batch(key, n, it=iter(fakes)):
        return jnp.asarray(next(it)[:n])

    def port_batch(rng, n, it=iter(fakes)):
        return _nchw(next(it)[:n])

    want = jax_fid.compute_fid(JaxDataset(records, 16, use_native=False),
                               jax_batch, config, num_images=40,
                               batch_size=16, extractor=ref)
    got = fid.compute_fid(ImageDataset(records, 16), port_batch, config,
                          num_images=40, batch_size=16, extractor=ext)
    assert got > 0 and got == pytest.approx(want, rel=1e-4)


def test_the_cache_key_is_jax_s_and_published_atomically(tmp_path, records,
                                                         monkeypatch):
    """Both packages' compute_fid, each in a working directory of its own,
    with extractors that share a ``cache_tag``: the same file name; the
    port's second call reads the cache and never runs the extractor on
    the records.  Without a dataset name, a sha1 of the data path."""
    ref, ext = _proxy_pair(32)
    ref.cache_tag = ext.cache_tag = "tagX"
    names = {}
    for side in ("jax", "port", "unnamed"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        config = _fid_config(records)
        config["data_seed"] = 3
        if side == "jax":
            jax_fid.compute_fid(JaxDataset(records, 16, use_native=False),
                                lambda key, n: jnp.asarray(_images(1, n, 32)),
                                config, num_images=32, batch_size=16,
                                extractor=ref)
        else:
            if side == "unnamed":
                del config["dataset"]
            fid.compute_fid(ImageDataset(records, 16),
                            lambda rng, n: _nchw(_images(1, n, 32)),
                            config, num_images=32, batch_size=16,
                            extractor=ext)
        names[side] = os.listdir(".cache")
    assert names["jax"] == names["port"] == ["synthetic_32_32_d-1s3_tagX.pkl"]
    (unnamed,) = names["unnamed"]
    assert unnamed.startswith("data_") and unnamed.endswith(
        "_32_32_d-1s3_tagX.pkl") and len(unnamed.split("_")[1]) == 10
    monkeypatch.chdir(tmp_path / "port")
    cache = os.path.join(".cache", names["port"][0])
    mu, sigma = fid.real_stats(None, None, 32, cache)   # no dataset read
    assert mu.shape == (256,) and sigma.shape == (256, 256)
    assert not [f for f in os.listdir(".cache") if f.endswith(".tmp")]


def test_backends_on_the_fallback_paths(tmp_path, capsys):
    npz = str(tmp_path / "inception.npz")
    write_random_weights_npz(npz, seed=0, include_top=False)
    corrupt = str(tmp_path / "corrupt.npz")
    with open(corrupt, "wb") as f:
        f.write(b"PK\x03\x04 not a zip")
    missing = str(tmp_path / "missing.npz")
    proxy = {"random_proxy": fid.PROXY_BACKEND, "inception": "inception"}
    cases = [({}, False), ({"inception_weights": missing}, True),
             ({"inception_weights": npz}, False),
             ({"fid_extractor": "random", "inception_weights": npz}, False)]
    for extra, warns in cases:
        config = {"img_size": 32, **extra}
        want = jax_fid.get_extractor(config).backend
        capsys.readouterr()
        assert fid.get_extractor(config).backend == proxy[want]
        assert ("WARNING" in capsys.readouterr().out) is warns
    with pytest.raises(FileNotFoundError, match="inception_weights"):
        fid.get_extractor({"img_size": 32, "fid_extractor": "inception",
                           "inception_weights": missing})
    # the classifier needs the top: a feature-only npz, a missing one and
    # a corrupt one take the proxy, loudly
    for weights in (None, npz, missing, corrupt):
        config = {"img_size": 32, "inception_weights": weights}
        want = jax_iscore.get_classifier(config).backend
        capsys.readouterr()
        assert iscore.get_classifier(config).backend == proxy[want] \
            == fid.PROXY_BACKEND
        assert ("WARNING" in capsys.readouterr().out) is bool(weights)
    write_random_weights_npz(npz, seed=0)
    config = {"img_size": 32, "inception_weights": npz}
    assert iscore.get_classifier(config).backend == "inception" \
        == jax_iscore.get_classifier(config).backend


def test_the_slice_jax_g_and_fid_against_the_port_s(tmp_path, records,
                                                    monkeypatch):
    """example_configs/test.py's vanilla G (gf 8, attention at 16) in fp32,
    JAX weights converted; the same numpy latents; the same records; JAX's
    proxy kernels in both: G -> features -> FID."""
    monkeypatch.chdir(tmp_path)
    config = _test_config()
    jgen = jax_generator(jax_resolve(config, num_local_devices=1))
    flat, variables = perturbed_export(jgen, seed=1)
    gen = get_generator(resolve_config(config, num_local_devices=1))
    gen.load_state_dict(state_from_jax(flat, gen))
    gen.eval()
    rs = np.random.RandomState(9)
    latents = [rs.randn(16, config["z_dim"]).astype(np.float32)
               for _ in range(3)]
    forward = jax.jit(lambda v, z: jgen(v, z, jnp.zeros(z.shape[0], jnp.int32),
                                        train=False)[0])

    def jax_batch(key, n, it=iter(latents)):
        return forward(variables, jnp.asarray(next(it)))

    def port_batch(rng, n, it=iter(latents)):
        z = torch.from_numpy(next(it))
        return gen(z, torch.zeros(n, dtype=torch.long)).float()

    ref, ext = _proxy_pair(32)
    fid_config = _fid_config(records)
    want = jax_fid.compute_fid(JaxDataset(records, 16, use_native=False),
                               jax_batch, fid_config, num_images=48,
                               batch_size=16, extractor=ref)
    got = fid.compute_fid(ImageDataset(records, 16), port_batch, fid_config,
                          num_images=48, batch_size=16, extractor=ext)
    assert got > 0 and got == pytest.approx(want, rel=1e-3)


def _test_config() -> dict:
    config = load_config_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "example_configs", "test.py"))
    config.update(img_size=32, num_classes=1, compute_dtype="float32",
                  num_devices=1)
    return config

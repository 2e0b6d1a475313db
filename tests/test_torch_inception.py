"""The port's InceptionV3 (``train/inception.py``) against the JAX one, on
an npz of random weights written from the port's unit table (the repo
holds no published weights): the JAX forward runs on that npz, so every
unit's shape is the graph's; features at 75 px, the smallest input the
graph takes (1e-4 of max|f|); the resize to 299 from 64 and 512 px
against ``jax.image.resize`` (1e-5); the extractor and the classifier at
299 (1e-5).  Then ``python -m sagan_tpu_torch.evaluate --device cpu`` end
to end on a tiny trained run, as JAX ``tests/test_evaluate.py`` holds
its CLI: the proxy keys, ``--no_is``, ``--raw_g``, the Inception keys on
the random npz, and an untrained run refused."""

import os

import jax
import numpy as np
import pytest
import torch

from sagan_tpu.train import inception as jax_inception
from sagan_tpu_torch import evaluate
from sagan_tpu_torch import main as train_cli
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.train import inception
from sagan_tpu_torch.train.fid import PROXY_BACKEND

from test_torch_trainer import _config_file


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inception") / "random.npz")
    inception.write_random_weights_npz(path, seed=0)
    return path


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _images(seed: int, n: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def test_the_unit_table_runs_the_jax_graph_at_75_px(weights):
    assert len(inception.UNITS) == inception.NUM_UNITS \
        == jax_inception.NUM_UNITS
    params = jax_inception.load_weights_npz(weights)
    x = _images(0, 2, 75)
    want = np.asarray(jax.jit(jax_inception.inception_v3_features)(params,
                                                                    x))
    net = inception.InceptionV3(inception.load_weights_npz(weights))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 512])
def test_the_resize_is_jax_image_resize(size):
    x = _images(size, 1, size)
    want = np.asarray(jax.image.resize(x, (1, 299, 299, 3), "bilinear"))
    got = inception.resize(_nchw(x), 299).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_features_and_classifier_at_299(weights):
    x = _images(3, 1, 64)
    want_f = jax_inception.InceptionV3Features(weights)(x)
    want_p = jax_inception.InceptionV3Classifier(weights)(x)
    feats = inception.InceptionV3Features(weights)
    cls = inception.InceptionV3Classifier(weights)
    with torch.no_grad():
        got_f = feats(_nchw(x)).numpy()
        got_p = cls(_nchw(x)).numpy()
    assert got_f.shape == (1, 2048) and got_p.shape == (1, 1000)
    np.testing.assert_allclose(got_f, want_f, rtol=0,
                               atol=1e-5 * np.abs(want_f).max())
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    assert feats.cache_tag.startswith("inception299_")
    assert cls.cache_tag.startswith("inception_cls299_")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A config file of a tiny run trained 2 steps on the CPU, EMA from
    step 0 (so the EMA and the raw G differ)."""
    tmp = tmp_path_factory.mktemp("evaluate")
    data = make_synthetic_dataset(str(tmp / "ds"), num=64, img_size=32,
                                  num_classes=1, seed=1)
    cfg = _config_file(tmp, data, epoch=1, data_size=16, g_ema_start=0,
                       img_dir=None, fid_num_images=16)
    train_cli.main(["--config_path", cfg, "--device", "cpu"])
    return tmp, cfg


def test_evaluate_proxy_keys_no_is_and_raw_g(trained, monkeypatch):
    tmp, cfg = trained
    monkeypatch.chdir(tmp)
    result = evaluate.main(["--config_path", cfg, "--device", "cpu"])
    assert result["step"] == 2 and result["ema"] is True
    assert result["extractor"] == result["is_classifier"] == PROXY_BACKEND
    assert "fid" not in result and "inception_score" not in result
    assert np.isfinite(result["proxy_fid"]) and result["proxy_fid"] > 0
    assert "NOT comparable" in result["proxy_fid_note"]
    assert result["proxy_inception_score"] >= 1.0
    again = evaluate.main(["--config_path", cfg, "--device", "cpu",
                           "--no_is"])
    assert again["proxy_fid"] == pytest.approx(result["proxy_fid"],
                                               rel=1e-5)
    assert "proxy_inception_score" not in again
    raw = evaluate.main(["--config_path", cfg, "--device", "cpu", "--no_is",
                         "--raw_g"])
    assert raw["ema"] is False and np.isfinite(raw["proxy_fid"])
    assert raw["proxy_fid"] != pytest.approx(result["proxy_fid"], rel=1e-6)


def test_evaluate_with_inception_weights(trained, weights, tmp_path,
                                         monkeypatch):
    tmp, cfg = trained
    monkeypatch.chdir(tmp)
    with_weights = tmp_path / "cfg_inception.py"
    with open(cfg) as f:   # batches of 2: InceptionV3 on 6 images in all
        with_weights.write_text(f.read() + f"config.update(batch_size=2, "
                                           f"inception_weights={weights!r})"
                                           f"\n")
    result = evaluate.main(["--config_path", str(with_weights), "--device",
                            "cpu", "--num_images", "2"])
    assert result["extractor"] == result["is_classifier"] == "inception"
    assert np.isfinite(result["fid"]) and result["fid"] >= 0
    assert result["inception_score"] >= 1.0
    assert not any(k.startswith("proxy") for k in result)


def test_evaluate_refuses_an_untrained_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = make_synthetic_dataset(str(tmp_path / "ds"), num=32, img_size=32,
                                  num_classes=1, seed=1)
    cfg = _config_file(tmp_path, data, ckpt_dir=str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="no trained checkpoint"):
        evaluate.main(["--config_path", cfg, "--device", "cpu"])
    assert not os.path.exists(tmp_path / ".cache")

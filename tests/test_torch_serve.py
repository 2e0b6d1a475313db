"""The port's serving path (sagan_tpu_torch/serve.py, generate.py) on the
CPU: a JAX export served by the port against JAX ``build_serve_fn``, the
HTTP endpoints and 400s of tests/test_serve.py, the ladder against the
JAX server's, and the entry points' refusal to run on the CPU unasked."""

import io
import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.generate import build_serve_fn as jax_serve_fn
from sagan_tpu.generate import export_generator_npz as jax_export
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.serve import GeneratorService as JaxService
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch import generate, serve
from sagan_tpu_torch.convert import export_generator_npz
from sagan_tpu_torch.generate import build_serve_fn, load_generator_npz
from sagan_tpu_torch.models import get_generator
from sagan_tpu_torch.serve import GeneratorService, make_server, request_cap
from sagan_tpu_torch.utils.config import resolve_config

TINY = {
    "dataset": "synthetic", "data_path": "unused",
    "model": "vanilla", "z_dim": 8, "gf_dim": 8, "df_dim": 8,
    "img_size": 16, "use_attention": True, "attn_dim_G": [8],
    "attn_dim_D": [8], "use_label": True, "use_cond_bn": True,
    "num_classes": 4, "batch_size": 4, "num_devices": 1,
    "lr_g": 1e-4, "lr_d": 4e-4, "decay_rate": 0.99,
    "compute_dtype": "float32",
}


def _tiny_cfg():
    return resolve_config(TINY, num_local_devices=1)


def _tiny_gen():
    return get_generator(_tiny_cfg(), rng=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def server():
    svc = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=4,
                           seed=0)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield "http://%s:%d" % srv.server_address[:2]
    srv.shutdown()
    srv.server_close()
    svc.close()
    t.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def test_jax_export_served_by_the_port_matches_jax_serve_fn(tmp_path):
    """Weights exported by the JAX package, loaded by the port: the same
    latents give the same uint8 images within 1 LSB (the fp32 rounding
    of x*127.5+127.5 may tie differently)."""
    cfg = jax_resolve(TINY, num_local_devices=1)
    jgen = jax_generator(cfg)
    variables = jgen.init(jax.random.PRNGKey(3))
    params = dict(variables["params"])
    params["attn8"] = {**params["attn8"], "sigma": jnp.float32(0.9)}
    variables = {"params": params, "aux": variables["aux"]}
    path = jax_export(jgen, variables, str(tmp_path / "g"), config=cfg)

    rs = np.random.RandomState(0)
    z = rs.randn(5, 8).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1])
    want = np.asarray(jax_serve_fn(jgen)(variables, jnp.asarray(z),
                                         jnp.asarray(labels)))
    gen = load_generator_npz(_tiny_cfg(), path, "cpu")
    got = build_serve_fn(gen)(torch.from_numpy(z),
                              torch.from_numpy(labels)).numpy()
    assert got.shape == want.shape == (5, 16, 16, 3)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert want.std() > 0


def test_port_export_round_trips_through_the_jax_loader(tmp_path):
    gen = _tiny_gen()
    path = export_generator_npz(gen, str(tmp_path / "g.npz"), _tiny_cfg())
    from sagan_tpu.generate import load_generator_npz as jax_load
    jgen, variables = jax_load(jax_resolve(TINY, num_local_devices=1), path)
    z = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    labels = np.array([3, 0, 2])
    want = np.asarray(jax_serve_fn(jgen)(variables, jnp.asarray(z),
                                         jnp.asarray(labels)))
    got = build_serve_fn(gen)(torch.from_numpy(z),
                              torch.from_numpy(labels)).numpy()
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    with np.load(path) as data:
        assert int(data["meta/img_size"]) == 16
        assert int(data["meta/num_classes"]) == 4


def test_healthz_and_meta(server):
    status, _, body = _get(server + "/healthz")
    assert (status, body) == (200, b"ok")
    status, _, body = _get(server + "/meta")
    assert status == 200
    assert json.loads(body) == {"img_size": 16, "z_dim": 8,
                                "num_classes": 4, "batch": 4,
                                "ladder": [1, 4], "num_devices": 1}


def test_sample_png_grid(server):
    status, headers, body = _get(server + "/sample?n=3&seed=1")
    assert status == 200
    assert headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


def test_sample_npz_rounds_to_n(server):
    status, _, body = _get(server + "/sample?n=6&seed=2&format=npz")
    assert status == 200
    imgs = np.load(io.BytesIO(body))["images"]
    assert imgs.shape == (6, 16, 16, 3)
    assert imgs.dtype == np.uint8


def test_sample_raw_shape_header(server):
    status, headers, body = _get(server + "/sample?n=2&seed=3&format=raw")
    assert status == 200
    assert headers["X-Image-Shape"] == "2x16x16x3"
    assert np.frombuffer(body, np.uint8).reshape(2, 16, 16, 3).any()


def test_seed_determinism_and_freshness(server):
    _, _, a = _get(server + "/sample?n=2&seed=5&format=raw")
    _, _, b = _get(server + "/sample?n=2&seed=5&format=raw")
    assert a == b
    _, _, c = _get(server + "/sample?n=2&format=raw")
    _, _, d = _get(server + "/sample?n=2&format=raw")
    assert c != d


def test_class_pinning(server):
    _, _, a = _get(server + "/sample?n=2&seed=7&class_id=1&format=raw")
    _, _, b = _get(server + "/sample?n=2&seed=7&class_id=3&format=raw")
    assert a != b


def test_truncation_changes_the_latents(server):
    _, _, a = _get(server + "/sample?n=2&seed=8&format=raw")
    _, _, b = _get(server + "/sample?n=2&seed=8&truncation=0.5&format=raw")
    assert a != b


def test_class_out_of_range_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/sample?n=1&class_id=99")
    assert ei.value.code == 400
    assert b"out of range" in ei.value.read()


@pytest.mark.parametrize("bad", ["n=abc", "seed=x", "class_id=x",
                                 "truncation=x"])
def test_malformed_query_param_is_400(server, bad):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/sample?" + bad)
    assert ei.value.code == 400
    assert b"bad query parameter" in ei.value.read()


def test_request_cap_scales_with_image_size(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/sample?n=5000&format=raw")
    assert ei.value.code == 400
    assert b"per-request cap 4096" in ei.value.read()
    assert 16 <= request_cap(16, 512) < 256
    assert request_cap(64, 4096) == 64
    assert request_cap(64, 64) == 4096


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/nope")
    assert ei.value.code == 404


def _computed(server):
    _, _, body = _get(server + "/metrics")
    for line in body.decode().splitlines():
        if line.startswith("sagan_images_computed_total"):
            return int(float(line.split()[1]))
    raise AssertionError("sagan_images_computed_total missing")


def test_ladder_small_request_skips_full_batch(server):
    before = _computed(server)
    _get(server + "/sample?n=1&seed=21&format=raw")
    assert _computed(server) - before == 1


def test_ladder_chunks_cover_request_with_bounded_waste(server):
    before = _computed(server)
    status, _, _ = _get(server + "/sample?n=6&seed=22&format=raw")
    assert status == 200
    assert _computed(server) - before == 8


def test_parallel_small_requests_dont_serialize_full_batches(server):
    before = _computed(server)
    results = []

    def one():
        results.append(_get(server + "/sample?n=1&format=raw")[0])

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == [200, 200]
    assert _computed(server) - before == 2


def test_metrics_endpoint_counts(server):
    _get(server + "/sample?n=3&seed=11&format=raw")
    status, headers, body = _get(server + "/metrics")
    assert status == 200 and headers["Content-Type"] == "text/plain"
    fields = {line.split()[0]: float(line.split()[1])
              for line in body.decode().splitlines()
              if not line.startswith("#")}
    assert fields["sagan_requests_total"] >= 1
    assert fields["sagan_images_total"] >= 3
    assert fields["sagan_sample_seconds_total"] > 0
    assert fields["sagan_serving_devices"] == 1


@pytest.mark.parametrize("ladder", [[1, 4, 8], [1, 8, 64], [4], [2, 3, 16],
                                    [1, 2, 4, 8, 16, 32, 64]])
def test_ladder_chunks_match_the_jax_server(ladder):
    """``_chunks`` is the JAX server's decomposition, unchanged."""
    port = types.SimpleNamespace(ladder=ladder)
    for n in range(1, 200):
        assert list(GeneratorService._chunks(port, n)) == \
            list(JaxService._chunks(port, n)), (ladder, n)


def test_ladder_tail_never_degenerates_into_unit_programs():
    svc = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=8,
                           seed=0, ladder=(1, 4))
    try:
        assert svc.ladder == [1, 4, 8]
        assert list(svc._chunks(7)) == [8]
        assert list(svc._chunks(11)) == [8, 4]
        imgs = svc.sample(7, seed=1, class_id=-1, truncation=0.0)
        assert imgs.shape == (7, 16, 16, 3)
        assert svc.images_computed_total == 8
    finally:
        svc.close()


def test_ladder_disabled_restores_whole_batch_rounding():
    svc = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=4,
                           seed=0, ladder=())
    try:
        assert svc.ladder == [4]
        svc.sample(1, seed=0, class_id=-1, truncation=0.0)
        assert svc.images_computed_total == 4
    finally:
        svc.close()


def test_forwards_run_on_one_inference_thread():
    """Callers on many threads, forwards on one: cuDNN plans stay cached
    and forwards never overlap."""
    svc = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=4,
                           seed=0)
    threads_seen = set()
    serve_fn = svc._fn

    def recording(z, labels):
        threads_seen.add(threading.get_ident())
        return serve_fn(z, labels)

    svc._fn = recording
    callers = [threading.Thread(
        target=svc.sample, args=(2, i, -1, 0.0)) for i in range(4)]
    try:
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in callers)
        assert len(threads_seen) == 1
        assert threading.get_ident() not in threads_seen
        assert svc.requests_total == 4
    finally:
        svc.close()


def test_multi_device_serving_raises():
    """More devices than are visible raise, as JAX's ``make_mesh`` does
    (the CPU counts as one)."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=4,
                         num_devices=2)


def test_multi_device_serving_runs():
    """Two devices: the ladder in multiples of 2, the same images as one
    device serving the same chunks, each device's slice on its own
    inference thread, and the device count in /metrics."""
    one = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=4,
                           seed=0, ladder=(2,))
    two = GeneratorService(_tiny_gen(), z_dim=8, num_classes=4, batch=3,
                           seed=0, num_devices=2, ladder=(1,),
                           devices=["cpu", "cpu"])
    try:
        assert two.ladder == one.ladder == [2, 4]
        assert two.num_devices == 2
        assert "sagan_serving_devices 2" in two.metrics_text()
        threads = set()
        forward = two._replica_fns[0]

        def recording(z, labels):
            threads.add(threading.current_thread().name)
            return forward(z, labels)

        two._replica_fns[0] = recording
        for n, seed in ((1, 0), (3, 1), (6, 2)):
            np.testing.assert_array_equal(two.sample(n, seed, -1, 0.0),
                                          one.sample(n, seed, -1, 0.0))
        assert threads == {"sagan-inference-1_0"}
    finally:
        one.close()
        two.close()


def _write_config(tmp_path):
    path = tmp_path / "tiny.py"
    cfg = {k: v for k, v in TINY.items()
           if k not in ("img_size", "num_classes")}
    path.write_text(f"config = {cfg!r}\n")
    return str(path)


@pytest.mark.parametrize("main", [serve.main, generate.main])
def test_entry_points_refuse_the_cpu_unasked(main, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = export_generator_npz(_tiny_gen(), str(tmp_path / "g.npz"),
                                   _tiny_cfg())
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--config_path", _write_config(tmp_path),
              "--weights", weights])


def test_generate_main_on_the_cpu_writes_samples(tmp_path):
    weights = export_generator_npz(_tiny_gen(), str(tmp_path / "g.npz"),
                                   _tiny_cfg())
    out = tmp_path / "out"
    written = generate.main([
        "--config_path", _write_config(tmp_path), "--weights", weights,
        "--device", "cpu", "--num", "5", "--batch", "2", "--seed", "3",
        "--truncation", "0.7", "--class_id", "2", "--out", str(out),
        "--format", "both"])
    assert len(written) == 2
    imgs = np.load(out / "samples_seed3.npz")["images"]
    assert imgs.shape == (5, 16, 16, 3) and imgs.dtype == np.uint8
    assert (out / "samples_seed3.png").stat().st_size > 0


def _two_checkpoints(tmp_path):
    """A ckpt_dir with steps 3 and 5 of two generators (no EMA), and a
    config naming it; returns (config path, {step: generator})."""
    from sagan_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    gens = {}
    for step in (3, 5):
        gen = get_generator(_tiny_cfg(),
                            rng=torch.Generator().manual_seed(step))
        mgr.save(step, {"step": step, "gen": gen.state_dict(), "ema": None,
                        "meta": {"img_size": 16, "num_classes": 4,
                                 "z_dim": 8}})
        gens[step] = gen
    path = tmp_path / "ckpt_cfg.py"
    cfg = {k: v for k, v in TINY.items()
           if k not in ("img_size", "num_classes")}
    path.write_text(f"config = {{**{cfg!r}, "
                    f"'ckpt_dir': {str(tmp_path / 'ckpt')!r}}}\n")
    return str(path), gens


def test_serve_step_serves_the_pinned_checkpoint(tmp_path, monkeypatch):
    """``serve --step`` hands that checkpoint's generator to the service
    (service and server stubbed, so that ``main`` returns); a missing step
    raises ``KeyError`` naming the saved ones."""
    cfg, gens = _two_checkpoints(tmp_path)
    served = []

    class Stub:
        server_address = ("127.0.0.1", 0)
        img_size, ladder = 16, (2,)

        def __init__(self, gen=None, **kwargs):
            if gen is not None:
                served.append(gen)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(serve, "GeneratorService", Stub)
    monkeypatch.setattr(serve, "make_server", lambda *a: Stub())
    for step in (3, None):
        serve.main(["--config_path", cfg, "--device", "cpu"]
                   + (["--step", str(step)] if step else []))
        got = served.pop(0).state_dict()
        for k, v in gens[step or 5].state_dict().items():
            assert torch.equal(got[k], v), k
    with pytest.raises(KeyError, match=r"step 4; available: \[3, 5\]"):
        serve.main(["--config_path", cfg, "--device", "cpu", "--step", "4"])

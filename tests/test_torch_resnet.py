"""The port's 'resnet' family (``models/resnet.py``) against the JAX
package's on the same weights (JAX's init, converted, perturbed off init:
BN statistics random, gamma/beta off 1/0, attention ``sigma`` nonzero)
and the same inputs, with ``use_pallas_sn`` off and on (the JAX side runs
its fused SN kernel in interpret mode, the port K7's plain version);
weights carried both ways by the JAX export and ``convert.py``; and the
legacy CLI.  fp32 on the CPU.

Tolerances: G's tanh output 1e-5 absolute; D's scores 1e-4 absolute (they
reach |x| ~ 10, so ~1e-5 relative): the same fp32 arithmetic with other
summation orders, as ``tests/test_torch_generator.py`` and
``tests/test_torch_discriminator.py`` hold the vanilla family."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu import legacy_main as jax_legacy
from sagan_tpu.generate import build_serve_fn as jax_serve_fn
from sagan_tpu.generate import export_generator_npz as jax_export
from sagan_tpu.generate import load_generator_npz as jax_load
from sagan_tpu.models import get_discriminator as jax_discriminator
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu.utils.trees import flatten_with_paths
from sagan_tpu_torch import legacy_main
from sagan_tpu_torch.convert import (export_generator_npz, flat_from_jax_tree,
                                     jax_flat_from_module, state_from_jax)
from sagan_tpu_torch.data.synthetic import make_synthetic_dataset
from sagan_tpu_torch.generate import build_serve_fn, load_generator_npz
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.models.resnet import ResDiscriminator, ResGenerator
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.nn.layers import _SNLayer
from sagan_tpu_torch.ops import cuda_spectral
from sagan_tpu_torch.utils.config import load_config_file, resolve_config

G_TOL = 1e-5
D_TOL = 1e-4

# 32 px: G 4 -> 8 -> 16 -> 32 with channels 32, 32, 16, 8 and attention at
# its 16 map; D 32 -> 16 -> 8 -> 4 with channels 8, 16, 32 and attention at
# its 8 map
SMALL = {
    "dataset": "synthetic", "data_path": "unused", "model": "resnet",
    "z_dim": 8, "gf_dim": 8, "df_dim": 8, "img_size": 32,
    "use_attention": True, "attn_dim_G": [16], "attn_dim_D": [8],
    "num_classes": 4, "batch_size": 4, "num_devices": 1, "lr_g": 1e-4,
    "lr_d": 4e-4, "compute_dtype": "float32",
}
CONDITIONAL = {"use_label": True, "use_cond_bn": True}
UNCONDITIONAL = {"use_label": False}
PALLAS_SN = {"use_pallas_sn": True, "pallas_interpret": True}
VARIANTS = {"conditional": CONDITIONAL, "unconditional": UNCONDITIONAL,
            "conditional_pallas_sn": {**CONDITIONAL, **PALLAS_SN},
            "unconditional_pallas_sn": {**UNCONDITIONAL, **PALLAS_SN}}


def _imagenet128(**extra):
    config = load_config_file("example_configs/imagenet128_cond.py")
    config.update(img_size=128, num_classes=1000, compute_dtype="float32",
                  **extra)
    return resolve_config(config, num_local_devices=1)


def _perturbed(variables, seed):
    """JAX variables perturbed off init, as the flat export dict and as a
    variable tree."""
    rs = np.random.RandomState(seed)
    flat, tree = {}, {}
    for section in ("params", "aux"):
        keys, leaves, treedef = flatten_with_paths(variables[section])
        new = []
        for k, leaf in zip(keys, leaves):
            a = np.asarray(leaf, np.float32)
            leaf_name = k.rsplit("/", 1)[-1]
            if leaf_name == "var":
                a = rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
            elif leaf_name in ("mean", "gamma", "beta", "b"):
                a = a + 0.2 * rs.randn(*a.shape).astype(np.float32)
            elif leaf_name == "sigma":
                a = np.full(a.shape, 0.5 + rs.rand(), np.float32)
            flat[f"{section}/{k}"] = a
            new.append(jnp.asarray(a))
        tree[section] = jax.tree.unflatten(treedef, new)
    return flat, tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_res_generator_matches_jax(variant):
    config = dict(SMALL, **VARIANTS[variant])
    jgen = jax_generator(jax_resolve(config, num_local_devices=1))
    flat, variables = _perturbed(jgen.init(jax.random.PRNGKey(0)), seed=1)
    rs = np.random.RandomState(2)
    z = rs.randn(3, 8).astype(np.float32)
    labels = rs.randint(0, 4, 3)
    want = np.asarray(jgen(variables, jnp.asarray(z), jnp.asarray(labels),
                           train=False)[0])

    gen = get_generator(resolve_config(config, num_local_devices=1))
    assert isinstance(gen, ResGenerator) and not gen.training
    gen.load_state_dict(state_from_jax(flat, gen))
    before = cuda_spectral.LAUNCHES
    with torch.no_grad():
        got = gen(torch.from_numpy(z), torch.from_numpy(labels))
    assert cuda_spectral.LAUNCHES == before   # CPU: the plain version
    assert got.shape == (3, 3, 32, 32)
    assert np.abs(want).max() > 0.05          # a signal to compare
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=G_TOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_res_discriminator_matches_jax(variant):
    """The projection head (ReLU, sum-pool, SN-Dense(1) + <feat,
    SN-Embed(label)>) and the unconditional 4x4 head on the final block's
    output with no ReLU, in eval mode; in training mode every SN ``u``
    moves as JAX's does."""
    config = dict(SMALL, **VARIANTS[variant])
    jdisc = jax_discriminator(jax_resolve(config, num_local_devices=1))
    flat, variables = _perturbed(jdisc.init(jax.random.PRNGKey(3)), seed=4)
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    labels = rs.randint(0, 4, 3)
    want = np.asarray(jdisc(variables, jnp.asarray(x), jnp.asarray(labels),
                            train=False)[0])
    want_train, aux = jdisc(variables, jnp.asarray(x), jnp.asarray(labels),
                            train=True)

    disc = get_discriminator(resolve_config(config, num_local_devices=1))
    assert isinstance(disc, ResDiscriminator)
    disc.load_state_dict(state_from_jax(flat, disc))
    img = torch.from_numpy(x).permute(0, 3, 1, 2)
    disc.eval()
    with torch.no_grad():
        got = disc(img, torch.from_numpy(labels))
    if config["use_label"]:
        assert got.shape == want.shape == (3, 1)
    else:
        assert got.shape == (3, 1, 4, 4) and want.shape == (3, 4, 4, 1)
        got = got.permute(0, 2, 3, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=D_TOL, rtol=0)

    disc.train()
    with torch.no_grad():
        got = disc(img, torch.from_numpy(labels))
    want_train = np.asarray(want_train)
    if not config["use_label"]:
        want_train = want_train.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want_train, atol=D_TOL, rtol=0)
    got_aux = jax_flat_from_module(disc)
    for name, value in flat_from_jax_tree({"aux": aux}).items():
        np.testing.assert_allclose(got_aux[name], value, atol=G_TOL,
                                   err_msg=name)


def test_imagenet128_generator_with_k7_matches_plain_sn():
    """The full-width imagenet128_cond G, one set of weights, with
    ``use_pallas_sn`` (K7's plain version) and without: within 1e-5 in
    eval mode, and the same u after a training-mode forward."""
    rng = torch.Generator().manual_seed(0)
    plain = get_generator(_imagenet128(), rng=rng)
    fused = get_generator(_imagenet128(use_pallas_sn=True))
    fused.load_state_dict(plain.state_dict())
    z = torch.randn(2, 128, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([3, 999])
    with torch.no_grad():
        want = plain(z, labels)
        got = fused(z, labels)
        torch.testing.assert_close(got, want, atol=G_TOL, rtol=0)
        plain.train()(z, labels)
        fused.train()(z, labels)
    for key, value in plain.state_dict().items():
        if key.endswith(".u"):
            torch.testing.assert_close(fused.state_dict()[key], value,
                                       atol=G_TOL, rtol=0)


def test_imagenet128_nets_have_the_reference_names_and_sites():
    config = _imagenet128(use_pallas_sn=True)
    gen, disc = get_generator(config), get_discriminator(config)
    sn = {tag: [m for m in net.modules() if isinstance(m, _SNLayer) and m.sn]
          for tag, net in (("G", gen), ("D", disc))}
    assert {tag: len(ms) for tag, ms in sn.items()} == {"G": 25, "D": 28}
    assert all(m.sn_backend == "pallas" for ms in sn.values() for m in ms)
    g, d = gen.state_dict(), disc.state_dict()
    assert tuple(g["stem.w"].shape) == (1128, 4096)
    assert tuple(g["up8.convt1.w"].shape) == (256, 256, 3, 3)    # IOHW
    assert tuple(g["up8.conv2.w"].shape) == (256, 256, 3, 3)     # OIHW
    assert tuple(g["up128.bn1.gamma"].shape) == (1000, 32)       # cond BN
    assert tuple(g["to_rgb.w"].shape) == (3, 16, 3, 3)
    assert tuple(d["down64.conv1.w"].shape) == (16, 3, 3, 3)
    assert tuple(d["final.conv_sc.w"].shape) == (256, 256, 3, 3)
    assert tuple(d["head.w"].shape) == (256, 1)
    assert tuple(d["embed.w"].shape) == (1000, 256)
    sites = {f"{tag}.{name}": (m.qk_dim, m.v_dim)
             for tag, net in (("G", gen), ("D", disc))
             for name, m in net.named_modules()
             if isinstance(m, SelfAttention)}
    assert sites == {"G.attn32": (8, 32), "G.attn64": (4, 16),
                     "D.attn64": (2, 8), "D.attn32": (4, 16)}


def test_jax_export_round_trips_through_the_port(tmp_path):
    """A JAX ``generate --export`` of a conditional ResNet G served by the
    port, and the port's export loaded by the JAX package: the same
    latents give the same uint8 images within 1 LSB."""
    config = dict(SMALL, **CONDITIONAL)
    jcfg = jax_resolve(config, num_local_devices=1)
    jgen = jax_generator(jcfg)
    _, variables = _perturbed(jgen.init(jax.random.PRNGKey(6)), seed=7)
    path = jax_export(jgen, variables, str(tmp_path / "g"), config=jcfg)
    rs = np.random.RandomState(8)
    z = rs.randn(5, 8).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1])
    want = np.asarray(jax_serve_fn(jgen)(variables, jnp.asarray(z),
                                         jnp.asarray(labels)))
    gen = load_generator_npz(resolve_config(config, num_local_devices=1),
                             path, "cpu")
    got = build_serve_fn(gen)(torch.from_numpy(z),
                              torch.from_numpy(labels)).numpy()
    assert got.shape == want.shape == (5, 32, 32, 3) and want.std() > 0
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1

    back = export_generator_npz(gen, str(tmp_path / "port.npz"), jcfg)
    jgen2, variables2 = jax_load(jcfg, back)
    again = np.asarray(jax_serve_fn(jgen2)(variables2, jnp.asarray(z),
                                           jnp.asarray(labels)))
    np.testing.assert_array_equal(again, want)


def _legacy_args(data_path, root):
    return ["--data_path", data_path, "--path_root", root, "-b", "2", "-e",
            "1", "-d", "4", "-n", "2", "-u", "2", "--z_dim", "16"]


def test_legacy_build_config_matches_jax(tmp_path):
    argv = _legacy_args("data/x", str(tmp_path))
    args = legacy_main.parse_args(argv + ["--device", "cpu"])
    assert args.device == "cpu"
    assert legacy_main.parse_args(["--data_path", "d"]).device == "cuda"
    want = jax_legacy.build_config(argparse.Namespace(
        **{k: v for k, v in vars(args).items() if k != "device"}))
    assert legacy_main.build_config(args) == want
    debug = legacy_main.parse_args(argv + ["--debug"])
    assert legacy_main.build_config(debug)["ckpt_dir"] is None


def test_legacy_cli_trains_the_conditional_resnet_on_the_cpu(tmp_path,
                                                             capsys):
    """One epoch of the legacy CLI (128 px, gf = df = 16, 1000 classes from
    the dataset) on four synthetic records: two steps of two D updates
    each, a checkpoint and a sample grid."""
    data = make_synthetic_dataset(str(tmp_path / "data"), num=4,
                                  img_size=128, num_classes=1000, seed=0)
    trainer = legacy_main.main(_legacy_args(data, str(tmp_path / "run"))
                               + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 0: G_loss=" in out
    assert trainer.global_step() == 2
    assert trainer.config["num_classes"] == 1000
    assert isinstance(trainer.state.gen, ResGenerator)
    assert (tmp_path / "run" / "images" / "epoch_0000.png").exists()
    assert any((tmp_path / "run" / "checkpoints").iterdir())
    assert all(torch.isfinite(p).all()
               for p in trainer.state.gen.parameters())

"""The port's discriminator against the JAX discriminator,
``disc(vars, img, labels, train=...)``, on the same weights (JAX's init,
converted; attention ``sigma`` nonzero) and the same images: the
unconditional PatchGAN head and the projection head at small widths, and
the church64 config at full width.  fp32 on the CPU, where both sides run
their plain attention.

Tolerances: outputs 1e-4 absolute (D's scores reach |x| ~ 10 after four
convs and two attention blocks, so 1e-4 is ~1e-5 relative: the same fp32
arithmetic with other summation orders); SN ``u`` after a training-mode
forward 1e-5 (unit vectors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.models import get_discriminator as jax_discriminator
from sagan_tpu.utils.config import load_config_file
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch.convert import (flat_from_jax_tree, jax_flat_from_module,
                                     state_from_jax)
from sagan_tpu_torch.models import get_discriminator
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.utils.config import resolve_config

OUT_TOL = 1e-4
U_TOL = 1e-5

SMALL = {
    "dataset": "synthetic", "data_path": "unused", "model": "vanilla",
    "z_dim": 8, "gf_dim": 8, "df_dim": 8, "img_size": 16,
    "use_attention": True, "attn_dim_G": [8], "attn_dim_D": [4],
    "num_classes": 4, "batch_size": 4, "num_devices": 1, "lr_g": 1e-4,
    "lr_d": 4e-4, "compute_dtype": "float32",
}


def _church64():
    config = load_config_file("example_configs/church64_attn.py")
    config.update(img_size=64, num_classes=1, compute_dtype="float32")
    return config


def _both(config, seed=0):
    """(JAX D, its variables with sigma 0.7, port D with the same)."""
    jdisc = jax_discriminator(jax_resolve(config, num_local_devices=1))
    variables = jdisc.init(jax.random.PRNGKey(seed))
    variables = {"aux": variables["aux"], "params": jax.tree_util
                 .tree_map_with_path(
                     lambda p, a: jnp.full_like(a, 0.7)
                     if getattr(p[-1], "key", None) == "sigma" else a,
                     variables["params"])}
    disc = get_discriminator(resolve_config(config, num_local_devices=1))
    disc.load_state_dict(state_from_jax(flat_from_jax_tree(variables), disc))
    return jdisc, variables, disc


def _images(config, batch, seed=1):
    rs = np.random.RandomState(seed)
    s = config["img_size"]
    x = rs.uniform(-1, 1, (batch, s, s, 3)).astype(np.float32)
    labels = rs.randint(0, config.get("num_classes", 1), batch)
    return x, labels


@pytest.mark.parametrize("name,config,batch", [
    ("small_unconditional", dict(SMALL, use_label=False), 3),
    ("small_projection", dict(SMALL, use_label=True), 3),
    ("church64_full_width", None, 2),
])
def test_discriminator_matches_jax(name, config, batch):
    config = config or _church64()
    jdisc, variables, disc = _both(config)
    x, labels = _images(config, batch)
    forward = jax.jit(lambda v, x, y: jdisc(v, x, y, train=False)[0])
    want = np.asarray(forward(variables, jnp.asarray(x), jnp.asarray(labels)))
    disc.eval()
    with torch.no_grad():
        got = disc(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(labels))
    if config.get("use_label"):
        assert got.shape == want.shape == (batch, 1)
    else:   # PatchGAN map: [B, 1, 4, 4] in the port, [B, 4, 4, 1] in JAX
        assert got.shape == (batch, 1, 4, 4) and want.shape == (batch, 4, 4, 1)
        got = got.permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 0.05   # a signal to compare
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("use_label", [False, True])
def test_training_mode_forward_updates_u_as_jax_does(use_label):
    config = dict(SMALL, use_label=use_label)
    jdisc, variables, disc = _both(config, seed=3)
    x, labels = _images(config, 4, seed=4)
    out, aux = jdisc(variables, jnp.asarray(x), jnp.asarray(labels),
                     train=True)
    disc.train()
    got = disc(torch.from_numpy(x).permute(0, 3, 1, 2),
               torch.from_numpy(labels))
    want_flat = flat_from_jax_tree({"aux": aux})
    got_flat = jax_flat_from_module(disc)
    moved = 0
    for name, want in want_flat.items():
        before = np.asarray(flat_from_jax_tree(variables)[name])
        np.testing.assert_allclose(got_flat[name], want, atol=U_TOL,
                                   err_msg=name)
        # a one-channel layer's u is +-1 and stays put
        moved += want.size == 1 or not np.allclose(want, before)
    assert moved == len(want_flat)   # every SN layer stored a new u
    # D has no BN: the training-mode outputs agree as the eval ones do
    want = np.asarray(out)
    if not use_label:
        want = want.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OUT_TOL)


def test_church64_discriminator_has_the_reference_names_and_sites():
    disc = get_discriminator(resolve_config(_church64(), num_local_devices=1))
    state = disc.state_dict()
    assert tuple(state["down32_conv.w"].shape) == (16, 3, 4, 4)   # OIHW
    assert tuple(state["down4_conv.w"].shape) == (128, 64, 4, 4)
    assert tuple(state["head_conv.w"].shape) == (1, 128, 4, 4)
    sites = {name: (m.qk_dim, m.v_dim) for name, m in disc.named_modules()
             if isinstance(m, SelfAttention)}
    assert sites == {"attn8": (8, 32), "attn4": (16, 64)}
    assert disc.training


def test_discriminator_init_is_reproducible_and_embedding_is_keras_uniform():
    cfg = resolve_config(dict(SMALL, use_label=True), num_local_devices=1)
    a = get_discriminator(cfg, rng=torch.Generator().manual_seed(5))
    b = get_discriminator(cfg, rng=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    w = a.state_dict()["embed.w"]
    assert tuple(w.shape) == (4, 16) and float(w.abs().max()) <= 0.05

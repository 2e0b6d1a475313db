"""The port's generator against the JAX generator, ``gen(vars, z, labels,
train=False)``, on the same weights (random BN statistics, gamma/beta
off 1/0, nonzero attention sigma) and the same latents: a small
conditional config with class-conditional BN, and the church64 config at
full width.  fp32 on the CPU, where both sides run their plain attention;
tolerance 1e-5 on the tanh output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.utils.config import load_config_file
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu.utils.trees import flatten_with_paths
from sagan_tpu_torch.convert import state_from_jax
from sagan_tpu_torch.models import get_generator
from sagan_tpu_torch.models.resnet import ResGenerator
from sagan_tpu_torch.models.vanilla import Generator
from sagan_tpu_torch.nn.layers import _SNLayer
from sagan_tpu_torch.utils.config import resolve_config

TOL = 1e-5

SMALL_COND = {
    "dataset": "synthetic", "data_path": "unused",
    "model": "vanilla", "z_dim": 8, "gf_dim": 8, "df_dim": 8,
    "img_size": 16, "use_attention": True, "attn_dim_G": [8],
    "attn_dim_D": [8], "use_label": True, "use_cond_bn": True,
    "num_classes": 4, "batch_size": 4, "num_devices": 1,
    "lr_g": 1e-4, "lr_d": 4e-4, "decay_rate": 0.99,
    "compute_dtype": "float32",
}


def _church64():
    config = load_config_file("example_configs/church64_attn.py")
    config.update(img_size=64, num_classes=1, compute_dtype="float32")
    return config


def perturbed_export(gen, seed=0):
    """A JAX generator's variables, perturbed off init, as the flat
    export dict, and the same as a JAX variable tree."""
    rs = np.random.RandomState(seed)
    variables = gen.init(jax.random.PRNGKey(seed))
    flat, tree = {}, {}
    for section in ("params", "aux"):
        keys, leaves, treedef = flatten_with_paths(variables[section])
        new = []
        for k, leaf in zip(keys, leaves):
            a = np.asarray(leaf, np.float32)
            leaf_name = k.rsplit("/", 1)[-1]
            if leaf_name == "var":
                a = rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
            elif leaf_name in ("mean", "gamma", "beta"):
                a = a + 0.2 * rs.randn(*a.shape).astype(np.float32)
            elif leaf_name == "sigma":
                a = np.full(a.shape, 0.5 + rs.rand(), np.float32)
            flat[f"{section}/{k}"] = a
            new.append(jnp.asarray(a))
        tree[section] = jax.tree.unflatten(treedef, new)
    return flat, tree


@pytest.mark.parametrize("name,config,batch", [
    ("small_conditional", SMALL_COND, 3),
    ("church64_full_width", None, 2),
])
def test_generator_matches_jax(name, config, batch):
    config = config or _church64()
    jgen = jax_generator(jax_resolve(config, num_local_devices=1))
    flat, variables = perturbed_export(jgen)
    rs = np.random.RandomState(5)
    z = rs.randn(batch, config["z_dim"]).astype(np.float32)
    labels = rs.randint(0, config.get("num_classes", 1), batch)
    forward = jax.jit(lambda v, z, y: jgen(v, z, y, train=False)[0])
    want = forward(variables, jnp.asarray(z), jnp.asarray(labels))

    gen = get_generator(resolve_config(config, num_local_devices=1))
    gen.load_state_dict(state_from_jax(flat, gen))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), torch.from_numpy(labels))
    assert got.shape == (batch, 3, config["img_size"], config["img_size"])
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(np.asarray(want)).max() > 0.05  # a signal to compare
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_church64_generator_has_the_reference_size_and_names():
    gen = get_generator(resolve_config(_church64(), num_local_devices=1))
    state = gen.state_dict()
    assert sum(t.numel() for t in state.values()) == 1_232_538
    assert tuple(state["stem.w"].shape) == (128, 4096)
    assert tuple(state["up8_conv.w"].shape) == (256, 128, 4, 4)  # IOHW
    assert tuple(state["to_rgb.w"].shape) == (3, 16, 4, 4)       # OIHW
    assert {"attn64.sigma", "attn32.sigma", "attn64.theta.u",
            "up64_bn.mean", "up64_bn.var"} <= state.keys()
    assert not gen.training


def test_generator_init_is_reproducible_from_a_seed():
    cfg = resolve_config(SMALL_COND, num_local_devices=1)
    a = get_generator(cfg, rng=torch.Generator().manual_seed(7)).state_dict()
    b = get_generator(cfg, rng=torch.Generator().manual_seed(7)).state_dict()
    c = get_generator(cfg, rng=torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.w"], c["stem.w"])
    # SN vectors start unit-norm; Keras glorot bound on the stem
    assert abs(float(torch.linalg.vector_norm(a["stem.u"])) - 1.0) < 1e-6
    limit = (6.0 / (12 + 2048)) ** 0.5
    assert float(a["stem.w"].abs().max()) <= limit


@pytest.mark.parametrize("update,error", [
    ({"model": "resnet"}, None),
    ({"use_pallas_sn": True}, None),
    ({"model": "nope"}, ValueError),
])
def test_unported_or_unknown_models_raise(update, error):
    """An unknown family raises; the resnet family and ``use_pallas_sn``,
    which raised before they were ported, now build (the resnet G, and
    every SN layer on the fused kernel K7)."""
    cfg = resolve_config({**SMALL_COND, **update}, num_local_devices=1)
    if error is not None:
        with pytest.raises(error):
            get_generator(cfg)
        return
    gen = get_generator(cfg)
    assert type(gen) is (ResGenerator if "model" in update else Generator)
    sn = {m.sn_backend for m in gen.modules()
          if isinstance(m, _SNLayer) and m.sn}
    assert sn == {"pallas" if "use_pallas_sn" in update else "xla"}

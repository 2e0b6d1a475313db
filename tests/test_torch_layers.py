"""Port layers (sagan_tpu_torch/nn, ops/spectral) against the JAX layers
on the same weights and inputs, moved across by the weight converter.
Everything in fp32; tolerance 1e-5 (same arithmetic, other summation
order).  Activations are NHWC on the JAX side and NCHW in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.nn import attention as jattention
from sagan_tpu.nn import layers as jlayers
from sagan_tpu.ops.spectral import spectral_normalize_xla
from sagan_tpu.utils.trees import flatten_with_paths
from sagan_tpu_torch.convert import (generator_state_from_jax,
                                     jax_flat_from_generator)
from sagan_tpu_torch.nn import attention as tattention
from sagan_tpu_torch.nn import layers as tlayers
from sagan_tpu_torch.ops.spectral import spectral_normalize

TOL = 1e-5


def _flat_vars(module, seed=0):
    """The JAX module's variables as a flat export dict, perturbed off
    their init values: BN stats random, gamma/beta away from 1/0, biases
    and attention sigma nonzero."""
    rs = np.random.RandomState(seed)
    variables = module.init(jax.random.PRNGKey(seed))
    flat = {}
    for section in ("params", "aux"):
        keys, leaves, _ = flatten_with_paths(variables[section])
        for k, leaf in zip(keys, leaves):
            a = np.asarray(leaf, np.float32)
            leaf_name = k.rsplit("/", 1)[-1]
            if leaf_name == "var":
                a = rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
            elif leaf_name in ("mean", "gamma", "beta", "b"):
                a = a + 0.3 * rs.randn(*a.shape).astype(np.float32)
            elif leaf_name == "sigma":
                a = np.full(a.shape, 0.8, np.float32)
            flat[f"{section}/{k}"] = a
    return flat


def _jax_vars(flat):
    out = {"params": {}, "aux": {}}
    for name, a in flat.items():
        section, *path = name.split("/")
        node = out[section]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(a)
    return out


def _load(port_module, flat):
    port_module.load_state_dict(generator_state_from_jax(flat, port_module))
    return port_module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind,n_iter", [
    ("dense", 1), ("conv", 1), ("conv_transpose", 1), ("conv_transpose", 3)])
def test_spectral_normalize_matches_jax(kind, n_iter):
    """sigma and w_bar against spectral_normalize_xla, with the port's own
    layouts: Dense [in, out] (out_dim -1), Conv OIHW (out_dim 0) and
    ConvTranspose IOHW, whose u axis is dim 1."""
    rs = np.random.RandomState(3)
    shape = (24, 10) if kind == "dense" else (4, 4, 6, 10)
    w = rs.randn(*shape).astype(np.float32)
    u = rs.randn(10).astype(np.float32)
    u /= np.linalg.norm(u)
    w_bar, u_new = spectral_normalize_xla(jnp.asarray(w), jnp.asarray(u),
                                          n_iter=n_iter)
    perm, out_dim = {"dense": ((0, 1), -1), "conv": ((3, 2, 0, 1), 0),
                     "conv_transpose": ((2, 3, 0, 1), 1)}[kind]
    tw = torch.from_numpy(w).permute(perm)
    got_w, got_u = spectral_normalize(tw, torch.from_numpy(u), n_iter,
                                      out_dim=out_dim)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(u_new), atol=TOL)
    back = got_w.permute(tuple(np.argsort(perm))).numpy()
    np.testing.assert_allclose(back, np.asarray(w_bar), atol=TOL)
    # sigma itself: w / w_bar
    np.testing.assert_allclose(w[0, 0] / back[0, 0],
                               w[0, 0] / np.asarray(w_bar)[0, 0], rtol=TOL)


# (name, JAX module, port module, JAX input shape NHWC or [B, F])
LAYERS = {
    "dense_sn": (lambda: jlayers.Dense(12, 20, sn=True),
                 lambda: tlayers.Dense(12, 20, sn=True), (3, 12)),
    "conv_1x1_sn": (lambda: jlayers.Conv(8, 4, kernel=1, sn=True),
                    lambda: tlayers.Conv(8, 4, kernel=1, sn=True),
                    (2, 5, 5, 8)),
    # 'SAME' 4x4 stride 1 pads (1, 2): the generator's to_rgb conv
    "conv_4x4_same": (lambda: jlayers.Conv(6, 3, kernel=4, use_bias=False),
                      lambda: tlayers.Conv(6, 3, kernel=4, use_bias=False),
                      (2, 8, 8, 6)),
    "conv_4x4_stride2_sn": (
        lambda: jlayers.Conv(3, 5, kernel=4, stride=2, sn=True),
        lambda: tlayers.Conv(3, 5, kernel=4, stride=2, sn=True),
        (2, 9, 9, 3)),
    "conv_transpose_sn": (
        lambda: jlayers.ConvTranspose(6, 4, use_bias=False, sn=True),
        lambda: tlayers.ConvTranspose(6, 4, use_bias=False, sn=True),
        (2, 4, 4, 6)),
    "conv_transpose_bias": (lambda: jlayers.ConvTranspose(5, 3),
                            lambda: tlayers.ConvTranspose(5, 3),
                            (2, 3, 5, 5)),
    "batch_norm": (lambda: jlayers.BatchNorm(6),
                   lambda: tlayers.BatchNorm(6), (3, 4, 4, 6)),
    "self_attention": (lambda: jattention.SelfAttention(16),
                       lambda: tattention.SelfAttention(16), (2, 8, 8, 16)),
    "self_attention_wide_heads": (
        lambda: jattention.SelfAttention(16, qk_dim=4, v_dim=16),
        lambda: tattention.SelfAttention(16, qk_dim=4, v_dim=16),
        (2, 4, 4, 16)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make_jax, make_port, shape = LAYERS[name]
    jmod = make_jax()
    flat = _flat_vars(jmod)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want, _ = jmod(_jax_vars(flat), jnp.asarray(x), train=False)
    port = _load(make_port(), flat)
    with torch.no_grad():
        if x.ndim == 4:
            got = _nhwc(port(_nchw(x)))
        else:
            got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    # the converter's inverse gives the export back
    back = jax_flat_from_generator(port)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_conditional_batch_norm_matches_jax():
    jmod = jlayers.ConditionalBatchNorm(6, num_classes=5)
    flat = _flat_vars(jmod, seed=2)
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3, 3, 6).astype(np.float32)
    labels = np.array([0, 4, 2, 4])
    want, _ = jmod(_jax_vars(flat), jnp.asarray(x), jnp.asarray(labels),
                   train=False)
    port = _load(tlayers.ConditionalBatchNorm(6, num_classes=5), flat)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_sn_u_is_kept_at_eval_and_stored_in_training():
    layer = tlayers.Conv(8, 4, kernel=1, sn=True,
                         rng=torch.Generator().manual_seed(0))
    u0 = layer.u.clone()
    x = torch.randn(1, 8, 3, 3)
    layer.eval()
    with torch.no_grad():
        layer(x)
    torch.testing.assert_close(layer.u, u0, rtol=0, atol=0)
    layer.train()
    with torch.no_grad():
        layer(x)
    assert not torch.equal(layer.u, u0)


def test_train_mode_batch_norm_raises_with_its_roadmap_item():
    bn = tlayers.BatchNorm(4).train()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        bn(torch.zeros(1, 4, 2, 2))


def test_conv_transpose_other_than_4x4_stride2_raises():
    with pytest.raises(NotImplementedError, match="resnet"):
        tlayers.ConvTranspose(4, 4, kernel=3, stride=2)

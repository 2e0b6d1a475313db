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
from sagan_tpu_torch.convert import (state_from_jax,
                                     jax_flat_from_module)
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
    port_module.load_state_dict(state_from_jax(flat, port_module))
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
    # the resnet G's 3x3/2 'SAME', padded (2, 1) by XLA: the last row and
    # column of torch's padding-0 output dropped
    "conv_transpose_3x3_stride2_sn": (
        lambda: jlayers.ConvTranspose(6, 4, kernel=3, stride=2, sn=True),
        lambda: tlayers.ConvTranspose(6, 4, kernel=3, stride=2, sn=True),
        (2, 5, 4, 6)),
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
    back = jax_flat_from_module(port)
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


@pytest.mark.parametrize("conditional", [False, True])
def test_train_mode_batch_norm_matches_jax(conditional):
    """(Conditional)BatchNorm in training mode against the JAX layer with
    ``train=True`` (``_bn_core``): the output, the running stats it
    stores, and the gradients of sum(y * w) in x, gamma and beta (they
    flow through the batch moments)."""
    c = 6
    jmod = (jlayers.ConditionalBatchNorm(c, num_classes=5) if conditional
            else jlayers.BatchNorm(c))
    flat = _flat_vars(jmod, seed=5)
    rs = np.random.RandomState(6)
    x = (2.0 * rs.randn(4, 3, 3, c) + 0.5).astype(np.float32)
    w = rs.randn(4, 3, 3, c).astype(np.float32)
    labels = np.array([0, 4, 2, 4])
    variables = _jax_vars(flat)
    extra = (jnp.asarray(labels),) if conditional else ()

    def loss(x, params):
        y, aux = jmod({"params": params, "aux": variables["aux"]}, x,
                      *extra, train=True)
        return jnp.sum(y * w), (y, aux)

    (_, (want_y, want_aux)), (want_gx, want_gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                            variables["params"])
    port = _load(tlayers.ConditionalBatchNorm(c, num_classes=5)
                 if conditional else tlayers.BatchNorm(c), flat).train()
    xt = _nchw(x).requires_grad_()
    y = port(xt, torch.from_numpy(labels)) if conditional else port(xt)
    gx, g_gamma, g_beta = torch.autograd.grad(
        (y * _nchw(w)).sum(), (xt, port.gamma, port.beta))
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), atol=TOL,
                               rtol=TOL)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, stat).numpy(),
                                   np.asarray(want_aux[stat]), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(_nhwc(gx), np.asarray(want_gx), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(g_gamma.numpy(), np.asarray(want_gp["gamma"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g_beta.numpy(), np.asarray(want_gp["beta"]),
                               atol=TOL, rtol=TOL)


def test_train_mode_batch_norm_stores_the_biased_variance():
    bn = tlayers.BatchNorm(2).train()
    x = torch.tensor([[1.0, 3.0], [5.0, 7.0]]).view(2, 2, 1, 1)
    x = x.expand(2, 2, 2, 2).contiguous()
    bn(x)
    # per channel: values {1, 5} and {3, 7}, biased variance 4
    torch.testing.assert_close(bn.mean, 0.01 * torch.tensor([3.0, 5.0]))
    torch.testing.assert_close(bn.var, 0.99 + 0.01 * torch.tensor([4.0, 4.0]))


@pytest.mark.parametrize("train", [False, True])
def test_sn_embedding_matches_jax(train):
    jmod = jlayers.Embedding(5, 6, sn=True)
    flat = _flat_vars(jmod, seed=7)
    ids = np.array([0, 4, 2, 4, 1])
    want, aux = jmod(_jax_vars(flat), jnp.asarray(ids), train=train)
    port = _load(tlayers.Embedding(5, 6, sn=True), flat).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    want_u = np.asarray(aux["u"]) if train else flat["aux/u"]
    np.testing.assert_allclose(port.u.numpy(), want_u, atol=TOL)


def test_global_sum_pool_is_an_fp32_spatial_sum():
    x = torch.arange(24, dtype=torch.bfloat16).view(1, 2, 3, 4)
    out = tlayers.global_sum_pool(x)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, torch.tensor([[66.0, 210.0]]))


@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (1, 1), (5, 2),
                                           (2, 2), (4, 1)])
def test_conv_transpose_other_than_4x4_stride2_raises(kernel, stride):
    """Kernels and strides other than the vanilla G's 4x4/2 no longer
    raise (the resnet family brought the general 'SAME' padding): each
    matches ``lax.conv_transpose(..., 'SAME', transpose_kernel=True)``."""
    rs = np.random.RandomState(kernel * 10 + stride)
    x = rs.randn(2, 5, 3, 4).astype(np.float32)
    w = rs.randn(kernel, kernel, 4, 3).astype(np.float32)
    want = jax.lax.conv_transpose(
        jnp.asarray(x), jnp.swapaxes(jnp.asarray(w), 2, 3),
        strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=True,
        precision=jax.lax.Precision.HIGHEST)
    layer = tlayers.ConvTranspose(4, 3, kernel=kernel, stride=stride,
                                  use_bias=False)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(w).permute(2, 3, 0, 1))
        got = _nhwc(layer(_nchw(x)))
    assert got.shape == (2, 5 * stride, 3 * stride, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
